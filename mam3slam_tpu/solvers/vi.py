"""Visual-inertial optimization family.

JAX-native equivalents of the reference's inertial g2o graphs
(``src/Optimizer.cc``: FullInertialBA :392, LocalInertialBA :2390,
PoseInertialOptimizationLastKeyFrame/LastFrame :4498/:4882,
InertialOptimization :3049/:3234/:3396, MergeInertialBA :3955; vertex/edge
types in ``src/G2oTypes.cc``).

Design: one unified nav-state block per keyframe — a 15-dof tangent
[rho(3), phi(3), v(3), bg(3), ba(3)] — instead of g2o's
VertexPose/VertexVelocity/VertexGyroBias/VertexAccBias quartet.  Edges:

* reprojection (analytic jacobians, shared with ``ba._edge_linearize``,
  padded into the first 6 tangent dims),
* preintegration edges between consecutive KFs (reference ``EdgeInertial``)
  fused with the bias random-walk edges (``EdgeGyroRW``/``EdgeAccRW``) into
  one 15-dim residual, whitened by the preintegration covariance;
  jacobians by per-edge forward-mode autodiff (vmapped — each edge is a
  tiny independent function, ideal for batching),
* the normal equations solve reuses the matrix-free Schur-PCG pattern of
  ``ba.py``: points eliminated per-point, the reduced nav-state system
  applied edge-wise with segment-sums (psum-able across a mesh).

States use the map convention T_cw (world->camera) with camera==body
(the reference's Tbc generalization folds into the preintegration frame;
mono rigs in the reference test fixtures use a single camera).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie
from mam3slam_tpu.solvers import ba as ba_mod
from mam3slam_tpu.solvers import imu as imu_mod

GRAVITY = imu_mod.GRAVITY


class InertialEdges(NamedTuple):
    """Preintegration constraints between nav states; [M]-shaped pytree."""

    i: jnp.ndarray        # [M] i32 earlier KF slot
    j: jnp.ndarray        # [M] i32 later KF slot
    preint: imu_mod.Preintegrated  # batched [M, ...]
    valid: jnp.ndarray    # [M] bool


class VIProblem(NamedTuple):
    cam_q: jnp.ndarray       # [K, 4] T_cw
    cam_t: jnp.ndarray       # [K, 3]
    vel: jnp.ndarray         # [K, 3] world-frame velocity
    bg: jnp.ndarray          # [K, 3] gyro bias
    ba: jnp.ndarray          # [K, 3] acc bias
    cam_params: jnp.ndarray  # [K, 8]
    pts: jnp.ndarray         # [P, 3]
    obs: ba_mod.Obs          # reprojection edges
    iedges: InertialEdges
    cam_free: jnp.ndarray    # [K] bool
    pt_free: jnp.ndarray     # [P] bool
    gravity: jnp.ndarray     # [3] world gravity vector


class VIResult(NamedTuple):
    cam_q: jnp.ndarray
    cam_t: jnp.ndarray
    vel: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    pts: jnp.ndarray
    cost: jnp.ndarray


def _body_state_from_tcw(q_cw, t_cw):
    """World-frame body rotation/position from T_cw (body == camera)."""
    q_wc = lie.quat_conj(q_cw)
    R_wb = lie.quat_to_matrix(q_wc)
    p_w = -lie.quat_rotate(q_wc, t_cw)
    return R_wb, p_w


def _edge_residual15(d_i, d_j, q_i, t_i, v_i, bg_i, ba_i,
                     q_j, t_j, v_j, bg_j, ba_j, preint, gravity):
    """15-dim residual of one inertial edge at tangent perturbations
    d_i, d_j (each [15] = [rho, phi, dv, dbg, dba]): EdgeInertial's 9-dim
    (rot, vel, pos) + 6-dim bias random walk.  Differentiable in d_*."""
    def retract(d, q, t, v, bg, ba):
        dT = lie.se3_exp(d[:6])
        nq = lie.quat_normalize(lie.quat_mul(dT.q, q))
        nt = lie.quat_rotate(dT.q, t) + dT.t
        return nq, nt, v + d[6:9], bg + d[9:12], ba + d[12:15]

    qi, ti, vi, bgi, bai = retract(d_i, q_i, t_i, v_i, bg_i, ba_i)
    qj, tj, vj, bgj, baj = retract(d_j, q_j, t_j, v_j, bg_j, ba_j)
    R_i, p_i = _body_state_from_tcw(qi, ti)
    R_j, p_j = _body_state_from_tcw(qj, tj)
    r9 = imu_mod.inertial_residual(preint, R_i, vi, p_i, R_j, vj, p_j,
                                   bgi, bai, gravity=gravity)
    # random walk between consecutive bias states (EdgeGyroRW/EdgeAccRW)
    return jnp.concatenate([r9, bgj - bgi, baj - bai])


def _edge_info15(preint: imu_mod.Preintegrated, walk_g2, walk_a2):
    """Edge information: inverse preintegration covariance (9x9) plus the
    bias random-walk information, assembled as one [15,15] block."""
    cov9 = preint.cov[:9, :9] + 1e-9 * jnp.eye(9)
    info = jnp.zeros((15, 15))
    info = info.at[:9, :9].set(jnp.linalg.inv(cov9))
    dt = jnp.maximum(preint.dt, 1e-6)
    info = info.at[9:12, 9:12].set(jnp.eye(3) / (walk_g2 * dt))
    info = info.at[12:15, 12:15].set(jnp.eye(3) / (walk_a2 * dt))
    return info


def _linearize_inertial(prob: VIProblem, walk_g2, walk_a2):
    """Batched residuals, jacobians and information for all inertial
    edges.  Returns (r [M,15], Ji [M,15,15], Jj [M,15,15], info [M,15,15])."""
    ie = prob.iedges

    def one(i, j, preint):
        args_i = (prob.cam_q[i], prob.cam_t[i], prob.vel[i],
                  prob.bg[i], prob.ba[i])
        args_j = (prob.cam_q[j], prob.cam_t[j], prob.vel[j],
                  prob.bg[j], prob.ba[j])
        z = jnp.zeros(15)

        def f(d_i, d_j):
            return _edge_residual15(d_i, d_j, *args_i, *args_j, preint,
                                    prob.gravity)

        r = f(z, z)
        Ji = jax.jacfwd(f, argnums=0)(z, z)
        Jj = jax.jacfwd(f, argnums=1)(z, z)
        info = _edge_info15(preint, walk_g2, walk_a2)
        return r, Ji, Jj, info

    return jax.vmap(one)(ie.i, ie.j, ie.preint)


def vi_cost(prob: VIProblem, kind: int, walk_g2, walk_a2,
            huber_delta2: float = ba_mod.CHI2_MONO):
    """Robust total cost (reprojection Huber + inertial quadratic)."""
    r, _, _, depth_ok = ba_mod._edge_linearize(
        prob.cam_q, prob.cam_t, prob.cam_params, kind, prob.pts, prob.obs)
    chi2 = prob.obs.w * jnp.sum(r * r, axis=-1)
    active = prob.obs.valid & depth_ok
    d2 = huber_delta2
    rho = jnp.where(chi2 <= d2, chi2,
                    2.0 * jnp.sqrt(d2 * jnp.maximum(chi2, 1e-12)) - d2)
    c_vis = jnp.sum(jnp.where(active, rho, 0.0))
    ri, _, _, info = _linearize_inertial(prob, walk_g2, walk_a2)
    ci = jnp.einsum("mi,mij,mj->m", ri, info, ri)
    c_in = jnp.sum(jnp.where(prob.iedges.valid, ci, 0.0))
    return c_vis + c_in


def _vi_lm_iteration(prob: VIProblem, kind: int, lam, walk_g2, walk_a2,
                     huber_delta2, cg_iters, axis_name=None):
    """One LM step over 15-dof nav blocks + Schur-eliminated points."""
    K = prob.cam_q.shape[0]
    P = prob.pts.shape[0]
    obs = prob.obs

    # ---- reprojection part (first 6 tangent dims of each nav block)
    r, Jc6, Jp, depth_ok = ba_mod._edge_linearize(
        prob.cam_q, prob.cam_t, prob.cam_params, kind, prob.pts, obs)
    chi2 = obs.w * jnp.sum(r * r, axis=-1)
    w_rob = ba_mod._huber_w(chi2, huber_delta2)
    w = jnp.where(obs.valid & depth_ok, obs.w * w_rob, 0.0)
    Jc6 = jnp.where(prob.cam_free[obs.cam][:, None, None], Jc6, 0.0)
    Jp = jnp.where(prob.pt_free[obs.pt][:, None, None], Jp, 0.0)
    wJc = Jc6 * w[:, None, None]
    wJp = Jp * w[:, None, None]

    g_c = jnp.zeros((K, 15)).at[:, :6].set(
        ba_mod._segsum(jnp.einsum("eij,ei->ej", wJc, r), obs.cam, K,
                       axis_name))
    g_p = ba_mod._segsum(jnp.einsum("eij,ei->ej", wJp, r), obs.pt, P,
                         axis_name)
    Hcc6 = ba_mod._segsum(jnp.einsum("eik,eij->ekj", wJc, Jc6), obs.cam, K,
                          axis_name)
    Hcc = jnp.zeros((K, 15, 15)).at[:, :6, :6].set(Hcc6)
    Hpp = ba_mod._segsum(jnp.einsum("eik,eij->ekj", wJp, Jp), obs.pt, P,
                         axis_name)
    W_e = jnp.einsum("eik,eij->ekj", wJc, Jp)  # [E, 6, 3]

    # ---- inertial part
    ri, Ji, Jj, info = _linearize_inertial(prob, walk_g2, walk_a2)
    ie = prob.iedges
    em = (ie.valid & prob.cam_free[ie.i] & prob.cam_free[ie.j])
    # fixed endpoints: zero that endpoint's jacobian but keep the edge if
    # the other endpoint is free (reference fixes boundary KFs)
    em_any = ie.valid & (prob.cam_free[ie.i] | prob.cam_free[ie.j])
    Ji = jnp.where((em_any & prob.cam_free[ie.i])[:, None, None], Ji, 0.0)
    Jj = jnp.where((em_any & prob.cam_free[ie.j])[:, None, None], Jj, 0.0)
    info = jnp.where(em_any[:, None, None], info, 0.0)
    del em

    IJi = jnp.einsum("mab,mbc->mac", info, Ji)   # [M, 15, 15]
    IJj = jnp.einsum("mab,mbc->mac", info, Jj)
    g_c = g_c + ba_mod._segsum(jnp.einsum("mac,ma->mc", IJi, ri), ie.i, K,
                               axis_name)
    g_c = g_c + ba_mod._segsum(jnp.einsum("mac,ma->mc", IJj, ri), ie.j, K,
                               axis_name)
    Hcc = Hcc + ba_mod._segsum(jnp.einsum("mca,mab->mcb", Ji.transpose(0, 2, 1), IJi),
                               ie.i, K, axis_name)
    Hcc = Hcc + ba_mod._segsum(jnp.einsum("mca,mab->mcb", Jj.transpose(0, 2, 1), IJj),
                               ie.j, K, axis_name)

    # ---- damping
    diag = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
    add = lam * jnp.maximum(diag, 1e-6) + 1e-8
    Hcc_l = Hcc + add[..., None] * jnp.eye(15)
    Hcc_l = jnp.where(prob.cam_free[:, None, None], Hcc_l,
                      jnp.eye(15)[None])
    diagp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_l = Hpp + (lam * jnp.maximum(diagp, 1e-6) + 1e-8)[..., None] * jnp.eye(3)
    Hpp_l = jnp.where(prob.pt_free[:, None, None], Hpp_l, jnp.eye(3)[None])
    Hpp_inv = ba_mod._spd_inv3(Hpp_l)

    # cross-edge Hessian blocks between i and j nav states
    Hij = jnp.einsum("mca,mab->mcb", Ji.transpose(0, 2, 1), IJj)  # [M,15,15]

    def S_mv(v):  # v: [K, 15]
        # visual Schur part acts on the first 6 dims
        v6 = v[:, :6]
        u = jnp.einsum("ekj,ek->ej", W_e, v6[obs.cam])
        y = ba_mod._segsum(u, obs.pt, P, axis_name)
        z = jnp.einsum("pij,pj->pi", Hpp_inv, y)
        back = jnp.einsum("ekj,ej->ek", W_e, z[obs.pt])
        out = jnp.einsum("kij,kj->ki", Hcc_l, v)
        out = out.at[:, :6].add(-ba_mod._segsum(back, obs.cam, K, axis_name))
        # inertial cross terms
        out = out + ba_mod._segsum(
            jnp.einsum("mcb,mb->mc", Hij, v[ie.j]), ie.i, K, axis_name)
        out = out + ba_mod._segsum(
            jnp.einsum("mbc,mb->mc", Hij, v[ie.i]), ie.j, K, axis_name)
        return out

    z0 = jnp.einsum("pij,pj->pi", Hpp_inv, g_p)
    b = -g_c
    b = b.at[:, :6].add(ba_mod._segsum(
        jnp.einsum("ekj,ej->ek", W_e, z0[obs.pt]), obs.cam, K, axis_name))

    WHW = jnp.einsum("eik,ekl,ejl->eij", W_e, Hpp_inv[obs.pt], W_e)
    S_diag = Hcc_l.at[:, :6, :6].add(
        -ba_mod._segsum(WHW, obs.cam, K, axis_name))
    M_inv = jnp.linalg.inv(S_diag + 1e-8 * jnp.eye(15))

    def precond(v):
        return jnp.einsum("kij,kj->ki", M_inv, v)

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
    dx = jnp.where(prob.cam_free[:, None], x, 0.0)  # [K, 15]

    u = jnp.einsum("ekj,ek->ej", W_e, dx[:, :6][obs.cam])
    y = ba_mod._segsum(u, obs.pt, P, axis_name)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, -g_p - y)
    dx_p = jnp.where(prob.pt_free[:, None], dx_p, 0.0)

    dT = lie.se3_exp(dx[:, :6])
    new_q = lie.quat_normalize(lie.quat_mul(dT.q, prob.cam_q))
    new_t = lie.quat_rotate(dT.q, prob.cam_t) + dT.t
    return (new_q, new_t, prob.vel + dx[:, 6:9], prob.bg + dx[:, 9:12],
            prob.ba + dx[:, 12:15], prob.pts + dx_p)


def run_vi_ba(prob: VIProblem, kind: int, calib: imu_mod.ImuCalib,
              iters: int = 10, cg_iters: int = 40,
              huber_delta2: float = ba_mod.CHI2_MONO,
              lam0: float = 1e-4, axis_name=None) -> VIResult:
    """Visual-inertial BA (reference FullInertialBA :392 semantics; with
    boundary KFs fixed via ``cam_free`` it is LocalInertialBA :2390 /
    MergeInertialBA :3955).  LM with accept/reject."""
    walk_g2 = calib.walk_g ** 2
    walk_a2 = calib.walk_a ** 2

    def cost_at(p):
        return vi_cost(p, kind, walk_g2, walk_a2, huber_delta2)

    def body(_, carry):
        prob_c, lam, cost = carry
        nq, nt, nv, nbg, nba, npts = _vi_lm_iteration(
            prob_c, kind, lam, walk_g2, walk_a2, huber_delta2, cg_iters,
            axis_name)
        trial = prob_c._replace(cam_q=nq, cam_t=nt, vel=nv, bg=nbg,
                                ba=nba, pts=npts)
        new_cost = cost_at(trial)
        accept = new_cost < cost
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 4.0, 1e4))
        prob_n = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b) if a.dtype != bool else b,
            trial, prob_c)
        cost = jnp.where(accept, new_cost, cost)
        return prob_n, lam, cost

    cost0 = cost_at(prob)
    prob_f, lam, cost = jax.lax.fori_loop(
        0, iters, body, (prob, jnp.asarray(lam0, jnp.float32), cost0))
    return VIResult(cam_q=prob_f.cam_q, cam_t=prob_f.cam_t, vel=prob_f.vel,
                    bg=prob_f.bg, ba=prob_f.ba, pts=prob_f.pts, cost=cost)


# ---------------------------------------------------------------------------
# IMU initialization (reference InertialOptimization :3049/:3234/:3396)
# ---------------------------------------------------------------------------

def inertial_optimization(cam_q, cam_t, kf_valid, iedges: InertialEdges,
                          calib: imu_mod.ImuCalib, fix_scale: bool = False,
                          iters: int = 30, prior_g: float = 1e2,
                          prior_a: float = 1e6):
    """Visual map fixed; estimate gravity direction, scale, one shared
    bias pair, and per-KF velocities (the reference's inertial-init
    optimization: VertexGDir + VertexScale + shared bias + velocities).

    Returns (R_wg [3,3], scale, bg [3], ba [3], vel [K,3]).  The map can
    then be transformed: p' = s * R_wg^T p (as the reference's
    ``Map::ApplyScaledRotation``).
    """
    K = cam_q.shape[0]
    R_wb, p_w = jax.vmap(_body_state_from_tcw)(cam_q, cam_t)
    g0 = jnp.asarray([0.0, 0.0, -GRAVITY])

    def unpack(x):
        phi_g = jnp.concatenate([x[0:2], jnp.zeros(1)])  # 2-dof gravity dir
        s = jnp.exp(x[2])
        bg = x[3:6]
        ba = x[6:9]
        vel = x[9:].reshape(K, 3)
        return phi_g, s, bg, ba, vel

    info9 = jax.vmap(
        lambda p: jnp.linalg.inv(p.cov[:9, :9] + 1e-9 * jnp.eye(9))
    )(iedges.preint)
    L9 = jnp.linalg.cholesky(info9 + 1e-9 * jnp.eye(9))

    def residuals(x):
        phi_g, s, bg, ba, vel = unpack(x)
        s_eff = jnp.where(fix_scale, 1.0, s)
        Rwg = lie.so3_exp(phi_g)
        g = Rwg @ g0

        def edge(i, j, preint, Lw):
            r9 = imu_mod.inertial_residual(
                preint, R_wb[i], vel[i], s_eff * p_w[i],
                R_wb[j], vel[j], s_eff * p_w[j], bg, ba, gravity=g)
            return Lw.T @ r9

        r = jax.vmap(edge)(iedges.i, iedges.j, iedges.preint, L9)
        r = jnp.where(iedges.valid[:, None], r, 0.0).reshape(-1)
        # bias priors (reference priorG/priorA)
        return jnp.concatenate([r, jnp.sqrt(prior_g) * bg,
                                jnp.sqrt(prior_a) * ba])

    x = jnp.zeros(9 + 3 * K)

    def gn_body(_, carry):
        x, lam = carry
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-6)) + 1e-9 * jnp.eye(H.shape[0])
        g = J.T @ r
        dx = jnp.linalg.solve(H, -g)
        x_new = x + dx
        better = jnp.sum(residuals(x_new) ** 2) < jnp.sum(r ** 2)
        x = jnp.where(better, x_new, x)
        lam = jnp.where(better, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 10.0, 1e6))
        return x, lam

    x, _ = jax.lax.fori_loop(0, iters, gn_body,
                             (x, jnp.asarray(1e-2, jnp.float32)))
    phi_g, s, bg, ba, vel = unpack(x)
    s = jnp.where(fix_scale, 1.0, s)
    return lie.so3_exp(phi_g), s, bg, ba, vel


# ---------------------------------------------------------------------------
# motion-only VI pose optimization (reference :4498/:4882)
# ---------------------------------------------------------------------------

def pose_inertial_optimization(q0, t0, v0, bg0, ba0, cam_params, kind: int,
                               pts, uv, w, valid,
                               q_ref, t_ref, v_ref, bg_ref, ba_ref,
                               preint: imu_mod.Preintegrated,
                               calib: imu_mod.ImuCalib,
                               gravity: Optional[jnp.ndarray] = None,
                               rounds: int = 4, iters: int = 6):
    """Current-frame nav state vs (a) reprojection of tracked map points
    (fixed), (b) the preintegration edge to the reference KF (fixed), and
    (c) bias random walk — ``PoseInertialOptimizationLastKeyFrame``.
    Returns (q, t, v, bg, ba, inlier [N] bool)."""
    g = (jnp.asarray([0.0, 0.0, -GRAVITY]) if gravity is None
         else gravity)
    delta2 = ba_mod.CHI2_MONO
    info15 = _edge_info15(preint, calib.walk_g ** 2, calib.walk_a ** 2)
    L15 = jnp.linalg.cholesky(info15 + 1e-9 * jnp.eye(15))
    z15 = jnp.zeros(15)

    def vis_residual(d, q, t):
        dT = lie.se3_exp(d[:6])
        nq = lie.quat_normalize(lie.quat_mul(dT.q, q))
        nt = lie.quat_rotate(dT.q, t) + dT.t
        Xc = lie.quat_rotate(nq[None], pts) + nt[None]
        cam = cam_mod.Camera(cam_params, kind)
        pred = cam_mod.project_ideal(cam, Xc)
        return pred - uv, Xc[:, 2]

    def inertial_r(d, q, t, v, bg, ba):
        r = _edge_residual15(z15, d, q_ref, t_ref, v_ref, bg_ref, ba_ref,
                             q, t, v, bg, ba, preint, g)
        return L15.T @ r

    def state_cost(q, t, v, bg, ba, active):
        r, depth = vis_residual(z15, q, t)
        chi2 = w * jnp.sum(r * r, axis=-1)
        rho = jnp.where(chi2 <= delta2, chi2,
                        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12))
                        - delta2)
        c_vis = jnp.sum(jnp.where(active & (depth > 1e-3), rho, 0.0))
        ri = inertial_r(z15, q, t, v, bg, ba)
        return c_vis + jnp.sum(ri * ri)

    def lm_rounds(q, t, v, bg, ba, active, robust):
        def body(_, carry):
            q, t, v, bg, ba, lam, bcost, bstate = carry
            # linearize both edge families at the current state
            r, depth = vis_residual(z15, q, t)
            Jv = jax.jacfwd(lambda d: vis_residual(d, q, t)[0])(z15)
            chi2 = w * jnp.sum(r * r, axis=-1)
            w_rob = (ba_mod._huber_w(chi2, delta2) if robust
                     else jnp.ones_like(chi2))
            we = jnp.where(active & (depth > 1e-3), w * w_rob, 0.0)
            H = jnp.einsum("n,nid,nie->de", we, Jv, Jv)
            gvec = jnp.einsum("n,nid,ni->d", we, Jv, r)
            ri = inertial_r(z15, q, t, v, bg, ba)
            Jin = jax.jacfwd(
                lambda d: inertial_r(d, q, t, v, bg, ba))(z15)
            H = H + Jin.T @ Jin
            gvec = gvec + Jin.T @ ri
            H = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-6)) + 1e-8 * jnp.eye(15)
            dx = jnp.linalg.solve(H, -gvec)
            dT = lie.se3_exp(dx[:6])
            nq = lie.quat_normalize(lie.quat_mul(dT.q, q))
            nt = lie.quat_rotate(dT.q, t) + dT.t
            nv = v + dx[6:9]
            nbg = bg + dx[9:12]
            nba = ba + dx[12:15]
            ncost = state_cost(nq, nt, nv, nbg, nba, active)
            accept = ncost < bcost
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e4))
            bstate = jax.tree.map(
                lambda a, b: jnp.where(accept, a, b),
                (nq, nt, nv, nbg, nba), bstate)
            bcost = jnp.where(accept, ncost, bcost)
            nq2, nt2, nv2, nbg2, nba2 = bstate
            return nq2, nt2, nv2, nbg2, nba2, lam, bcost, bstate

        cost0 = state_cost(q, t, v, bg, ba, active)
        carry = (q, t, v, bg, ba, jnp.asarray(1e-3, jnp.float32), cost0,
                 (q, t, v, bg, ba))
        carry = jax.lax.fori_loop(0, iters, body, carry)
        return carry[7]

    q, t, v, bg, ba = q0, t0, v0, bg0, ba0
    active = valid
    for rd in range(rounds):
        q, t, v, bg, ba = lm_rounds(q, t, v, bg, ba, active,
                                    robust=(rd < 2))
        r, depth = vis_residual(z15, q, t)
        chi2 = w * jnp.sum(r * r, axis=-1)
        active = valid & (depth > 1e-3) & (chi2 <= delta2)
    return q, t, v, bg, ba, active

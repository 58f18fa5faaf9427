"""Scatter-free windowed / global bundle adjustment (dense two-view Schur).

JAX-native second-generation BA core replacing the edge-list formulation in
``solvers/ba.py`` for the windowed-LBA / welding-BA / global-BA paths
(reference ``Optimizer::LocalBundleAdjustment`` src/Optimizer.cc:1116, merge
overload :3505, ``GlobalBundleAdjustemnt`` :52).

Why a second formulation: the edge-list solver reduces per-vertex blocks
with ``.at[].add`` scatter-adds over arena-sized arrays — hundreds of them
per solve inside the CG loop, and duplicate-index scatters serialize (or
need atomics) on an accelerator.  Here the observation structure is laid out DENSELY in both
directions once, so every reduction in the hot loop is a plain ``sum`` over
a trailing axis and every irregular access is a dense gather:

* **camera-major view** ``[Kc, F]``: for each *free* camera, its F feature
  slots (uv, weight, point-slot).  Reductions over F produce the 6x6
  ``Hcc`` blocks, camera gradients, and the ``W z`` half of the Schur
  matvec.
* **point-major view** ``[Pw, M]``: for each window point, its <=M
  observations from the reverse-observation table (``mp_obs_kf/feat``),
  including observations from FIXED cameras (which contribute to ``Hpp``
  and the gradient but have no pose jacobian).  Reductions over M produce
  the 3x3 ``Hpp`` blocks, point gradients, and the ``W^T v`` half.

Free-camera edges are linearized once in the camera-major view; the
point-major view *gathers* those per-edge tensors (via the
``cslot * F + feat`` flat index), so both views are numerically identical
and the implicit Schur operator stays exactly symmetric.  Fixed-camera
edges are linearized directly in the point-major view (their ``Jc`` is
irrelevant).  The only scatters left are in problem build / result
write-back — once per solve, outside the LM x CG loops.

LM semantics match ``ba.run_ba``: Huber(sqrt(5.991)) IRLS, additive
diagonal damping with accept/reject, chi2 inlier classification in the
result (reference 10-iteration budget, post-hoc outlier edge removal).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie

CHI2_MONO = 5.991


class WindowProblem(NamedTuple):
    """Dense two-view BA problem.  Kc = free-camera cap, F = features per
    keyframe, Pw = window-point cap, M = reverse-observation cap."""

    # free-camera block [Kc]
    cam_idx: jnp.ndarray      # arena KF slot, -1 = unused
    cam_valid: jnp.ndarray    # bool
    cam_q: jnp.ndarray        # [Kc, 4]
    cam_t: jnp.ndarray        # [Kc, 3]
    cam_params: jnp.ndarray   # [Kc, 8]
    # camera-major edges [Kc, F]
    cm_uv: jnp.ndarray        # [Kc, F, 2]
    cm_w: jnp.ndarray         # [Kc, F] information (1/sigma^2)
    cm_pt: jnp.ndarray        # [Kc, F] point slot into Pw, -1 = none
    cm_mslot: jnp.ndarray     # [Kc, F] obs slot m of this edge in the
    #                           point-major view (gather bridge cm<-pm)
    cm_valid: jnp.ndarray     # [Kc, F] bool
    # point block [Pw]
    pt_idx: jnp.ndarray       # arena MP slot, -1 = unused
    pt_valid: jnp.ndarray
    pts: jnp.ndarray          # [Pw, 3]
    # point-major edges [Pw, M]
    pm_kf: jnp.ndarray        # arena KF slot of the observer
    pm_feat: jnp.ndarray      # feature index in that KF
    pm_cslot: jnp.ndarray     # free-camera slot, -1 = fixed camera
    pm_uv: jnp.ndarray        # [Pw, M, 2]
    pm_w: jnp.ndarray         # [Pw, M]
    pm_valid: jnp.ndarray     # [Pw, M]
    # fixed-observer pose/intrinsics snapshots (constant over the solve)
    pm_q0: jnp.ndarray        # [Pw, M, 4]
    pm_t0: jnp.ndarray        # [Pw, M, 3]
    pm_params0: jnp.ndarray   # [Pw, M, 8]
    # arena-sized slot maps (gather-based write-back, no scatters)
    cam_slot_of: jnp.ndarray  # [K] free-cam slot or -1
    pt_slot_of: jnp.ndarray   # [P] window-point slot or -1


class WindowResult(NamedTuple):
    cam_q: jnp.ndarray        # [Kc, 4]
    cam_t: jnp.ndarray        # [Kc, 3]
    pts: jnp.ndarray          # [Pw, 3]
    pm_inlier: jnp.ndarray    # [Pw, M] bool, chi2-gated at the solution
    cost: jnp.ndarray         # [] robust cost


def _huber_w(chi2, delta2):
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


def _rho(chi2, delta2):
    return jnp.where(chi2 <= delta2, chi2,
                     2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12))
                     - delta2)


def _cm_linearize(prob: WindowProblem, kind, cam_q, cam_t, pts):
    """Camera-major residuals/jacobians [Kc, F, ...] for free-cam edges."""
    X = pts[jnp.clip(prob.cm_pt, 0)]                       # [Kc, F, 3]
    Xc = lie.quat_rotate(cam_q[:, None, :], X) + cam_t[:, None, :]
    cam = cam_mod.Camera(prob.cam_params[:, None, :], kind)
    pred = cam_mod.project_ideal(cam, Xc)
    r = pred - prob.cm_uv                                  # [Kc, F, 2]
    dpi = cam_mod.project_jac(cam, Xc)                     # [Kc, F, 2, 3]
    Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)
    R = lie.quat_to_matrix(cam_q)                          # [Kc, 3, 3]
    Jp = dpi @ R[:, None]                                  # [Kc, F, 2, 3]
    depth_ok = Xc[..., 2] > 1e-3
    return r, Jc, Jp, depth_ok


def _pm_fixed_linearize(prob: WindowProblem, kind, pts):
    """Point-major residuals/jacobians [Pw, M, ...] for FIXED-cam edges
    (constant poses, so only point jacobians matter)."""
    Xc = lie.quat_rotate(prob.pm_q0, pts[:, None, :]) + prob.pm_t0
    cam = cam_mod.Camera(prob.pm_params0, kind)
    pred = cam_mod.project_ideal(cam, Xc)
    r = pred - prob.pm_uv
    dpi = cam_mod.project_jac(cam, Xc)
    R = lie.quat_to_matrix(prob.pm_q0)                     # [Pw, M, 3, 3]
    Jp = dpi @ R
    depth_ok = Xc[..., 2] > 1e-3
    return r, Jp, depth_ok


def _gather_cm(flat, cslot, feat, F):
    """Gather camera-major per-edge tensors into point-major layout.
    ``flat``: [Kc*F, ...]; invalid (fixed-cam) slots read row 0 — callers
    mask with ``is_free``."""
    idx = jnp.clip(cslot, 0) * F + jnp.clip(feat, 0)
    return flat[idx]


def _spd_inv3(A):
    """Closed-form cofactor inverse of batched 3x3 SPD blocks — fully
    vectorized (a batched pivoted LU would loop over the 3 pivots with
    data-dependent row swaps for every point of the batch)."""
    A = A + 1e-8 * jnp.eye(3, dtype=A.dtype)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = c * h - b * i
    C02 = b * f - c * e
    C10 = f * g - d * i
    C11 = a * i - c * g
    C12 = c * d - a * f
    C20 = d * h - e * g
    C21 = b * g - a * h
    C22 = a * e - b * d
    det = a * C00 + b * C10 + c * C20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    M = jnp.stack([jnp.stack([C00, C01, C02], -1),
                   jnp.stack([C10, C11, C12], -1),
                   jnp.stack([C20, C21, C22], -1)], -2)
    return M * inv_det[..., None, None]


def _spd_inv6(A):
    return jnp.linalg.inv(A + 1e-8 * jnp.eye(6, dtype=A.dtype))


def _chol3(A):
    """Closed-form Cholesky of batched 3x3 SPD blocks (A = L L^T, L lower).
    Fully vectorized — used to factor ``Hpp^-1`` for the explicit Schur
    product ``Z Hpp^-1 Z^T = (Z L)(Z L)^T``."""
    a11 = jnp.sqrt(jnp.maximum(A[..., 0, 0], 1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    l22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 * l21, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l31 * l31 - l32 * l32,
                               1e-20))
    z = jnp.zeros_like(a11)
    return jnp.stack([jnp.stack([a11, z, z], -1),
                      jnp.stack([l21, l22, z], -1),
                      jnp.stack([l31, l32, l33], -1)], -2)


def window_cost_and_inliers(prob: WindowProblem, kind, cam_q, cam_t, pts,
                            chi2_th: float = CHI2_MONO):
    """Robust cost + chi2 inlier mask over the point-major edge set (which
    covers EVERY edge exactly once: free-cam edges gathered, fixed-cam
    edges direct)."""
    F = prob.cm_uv.shape[1]
    is_free = prob.pm_cslot >= 0
    r_cm, _, _, dok_cm = _cm_linearize(prob, kind, cam_q, cam_t, pts)
    r_fx, _, dok_fx = _pm_fixed_linearize(prob, kind, pts)
    r_free = _gather_cm(r_cm.reshape(-1, 2), prob.pm_cslot, prob.pm_feat, F)
    dok_free = _gather_cm(dok_cm.reshape(-1), prob.pm_cslot, prob.pm_feat, F)
    r = jnp.where(is_free[..., None], r_free, r_fx)
    dok = jnp.where(is_free, dok_free, dok_fx)
    chi2 = prob.pm_w * jnp.sum(r * r, axis=-1)
    active = prob.pm_valid & dok
    cost = jnp.sum(jnp.where(active, _rho(chi2, chi2_th), 0.0))
    inlier = active & (chi2 < chi2_th)
    return cost, inlier


def cm_mask_from_pm(prob: WindowProblem, pm_mask):
    """Project a point-major edge mask onto the camera-major grid via the
    precomputed (point, obs-slot) bridge — a pure gather (each free-cam
    edge has exactly one pm slot, recorded in cm_mslot at build)."""
    return pm_mask[jnp.clip(prob.cm_pt, 0),
                   jnp.clip(prob.cm_mslot, 0)] & prob.cm_valid


def _lm_iteration(prob: WindowProblem, kind, cam_q, cam_t, pts, lam,
                  pm_edge_mask, cm_edge_mask, huber_delta2, cg_iters,
                  robust):
    Kc, F = prob.cm_uv.shape[:2]
    is_free = prob.pm_cslot >= 0

    # ---- linearize once (camera-major for free edges, direct for fixed)
    r_cm, Jc_cm, Jp_cm, dok_cm = _cm_linearize(prob, kind, cam_q, cam_t,
                                               pts)
    r_fx, Jp_fx, dok_fx = _pm_fixed_linearize(prob, kind, pts)

    # point-major copies of the free-cam edge tensors (exact same values)
    r_pm = jnp.where(
        is_free[..., None],
        _gather_cm(r_cm.reshape(-1, 2), prob.pm_cslot, prob.pm_feat, F),
        r_fx)
    Jp_pm = jnp.where(
        is_free[..., None, None],
        _gather_cm(Jp_cm.reshape(-1, 2, 3), prob.pm_cslot, prob.pm_feat, F),
        Jp_fx)
    dok_pm = jnp.where(
        is_free,
        _gather_cm(dok_cm.reshape(-1), prob.pm_cslot, prob.pm_feat, F),
        dok_fx)

    chi2_pm = prob.pm_w * jnp.sum(r_pm * r_pm, axis=-1)
    # robust cost at the linearization point — returned so the caller can
    # run the accept/reject of the PREVIOUS trial from this linearization
    # instead of paying a second full linearization per LM iteration
    cost_here = jnp.sum(jnp.where(pm_edge_mask & dok_pm,
                                  _rho(chi2_pm, huber_delta2), 0.0))
    w_rob_pm = _huber_w(chi2_pm, huber_delta2) if robust \
        else jnp.ones_like(chi2_pm)
    w_pm = jnp.where(pm_edge_mask & dok_pm, prob.pm_w * w_rob_pm, 0.0)

    # camera-major weights: recomputed from identical r (bit-identical
    # inputs), with the per-run edge mask pre-projected onto the cm grid
    # (cm_mask_from_pm) so both views weight exactly the same edge set.
    chi2_cm = prob.cm_w * jnp.sum(r_cm * r_cm, axis=-1)
    w_rob_cm = _huber_w(chi2_cm, huber_delta2) if robust \
        else jnp.ones_like(chi2_cm)
    w_cm = jnp.where(cm_edge_mask & dok_cm, prob.cm_w * w_rob_cm, 0.0)

    # ---- blocks (all reductions are dense axis sums)
    wJc = Jc_cm * w_cm[..., None, None]                    # [Kc, F, 2, 6]
    wJp_cm = Jp_cm * w_cm[..., None, None]
    g_c = jnp.einsum("kfij,kfi->kj", wJc, r_cm)            # [Kc, 6]
    Hcc = jnp.einsum("kfia,kfib->kab", wJc, Jc_cm)         # [Kc, 6, 6]
    W_cm = jnp.einsum("kfia,kfib->kfab", wJc, Jp_cm)       # [Kc, F, 6, 3]

    wJp_pm = Jp_pm * w_pm[..., None, None]                 # [Pw, M, 2, 3]
    g_p = jnp.einsum("pmij,pmi->pj", wJp_pm, r_pm)         # [Pw, 3]
    Hpp = jnp.einsum("pmia,pmib->pab", wJp_pm, Jp_pm)      # [Pw, 3, 3]
    W_pm = jnp.where(
        is_free[..., None, None],
        _gather_cm(W_cm.reshape(-1, 6, 3), prob.pm_cslot, prob.pm_feat, F),
        0.0)                                               # [Pw, M, 6, 3]

    # ---- LM damping; fixed/invalid vertices get identity blocks
    def damp(H, free, dim):
        diag = jnp.diagonal(H, axis1=-2, axis2=-1)
        add = lam * jnp.maximum(diag, 1e-6) + 1e-8
        H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
        return jnp.where(free[:, None, None], H,
                         jnp.eye(dim, dtype=H.dtype))

    Hcc_l = damp(Hcc, prob.cam_valid, 6)
    Hpp_l = damp(Hpp, prob.pt_valid, 3)
    Hpp_inv = _spd_inv3(Hpp_l)

    ptc = jnp.clip(prob.cm_pt, 0)

    def S_mv(v):                                           # v: [Kc, 6]
        vc = v[jnp.clip(prob.pm_cslot, 0)]                 # [Pw, M, 6]
        u = jnp.einsum("pmab,pma->pb", W_pm, vc)           # [Pw, 3]
        z = jnp.einsum("pab,pb->pa", Hpp_inv, u)           # [Pw, 3]
        zk = z[ptc]                                        # [Kc, F, 3]
        back = jnp.einsum("kfab,kfb->ka", W_cm, zk)        # [Kc, 6]
        return jnp.einsum("kab,kb->ka", Hcc_l, v) - back

    z0 = jnp.einsum("pab,pb->pa", Hpp_inv, g_p)
    b = -g_c + jnp.einsum("kfab,kfb->ka", W_cm, z0[ptc])

    # block-Jacobi preconditioner of the reduced camera system
    WHW = jnp.einsum("kfab,kfbc,kfdc->kfad", W_cm, Hpp_inv[ptc], W_cm)
    M_inv = _spd_inv6(Hcc_l - jnp.sum(WHW, axis=1))

    def precond(v):
        return jnp.einsum("kab,kb->ka", M_inv, v)

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
    dx_c = jnp.where(prob.cam_valid[:, None], x, 0.0)

    # point back-substitution
    vc = dx_c[jnp.clip(prob.pm_cslot, 0)]
    u = jnp.einsum("pmab,pma->pb", W_pm, vc)
    dx_p = jnp.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
    dx_p = jnp.where(prob.pt_valid[:, None], dx_p, 0.0)

    dT = lie.se3_exp(dx_c)
    new_q = lie.quat_normalize(lie.quat_mul(dT.q, cam_q))
    new_t = lie.quat_rotate(dT.q, cam_t) + dT.t
    return new_q, new_t, pts + dx_p, cost_here


def run_window_ba(prob: WindowProblem, kind: int, iters: int = 10,
                  cg_iters: int = 30, huber_delta2: float = CHI2_MONO,
                  robust: bool = True, chi2_th: float = CHI2_MONO,
                  pm_edge_mask=None, lam0: float = 1e-4) -> WindowResult:
    """LM loop with accept/reject + adaptive damping.  jit-able."""
    mask0 = prob.pm_valid if pm_edge_mask is None \
        else (prob.pm_valid & pm_edge_mask)
    cm_mask0 = cm_mask_from_pm(prob, mask0)

    def body(_, carry):
        """One linearization per iteration: the trial point's cost is
        evaluated by the NEXT iteration's linearization (which computes it
        anyway), halving sequential work vs evaluate-then-accept.  A
        rejected trial re-steps from the best point using this
        linearization as its approximation (valid: rejected steps are
        small) — the scheme pose_optimization uses."""
        bq, bt, bp, bcost, q, t, p, lam = carry
        nq, nt, np_, cost = _lm_iteration(prob, kind, q, t, p, lam, mask0,
                                          cm_mask0, huber_delta2, cg_iters,
                                          robust)
        accept = cost < bcost
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 4.0, 1e4))
        bq = jnp.where(accept, q, bq)
        bt = jnp.where(accept, t, bt)
        bp = jnp.where(accept, p, bp)
        bcost = jnp.where(accept, cost, bcost)
        # apply the computed se3/point step from the best point
        dq = lie.quat_mul(nq, lie.quat_conj(q))        # = dT.q
        dt = nt - lie.quat_rotate(dq, t)               # = dT.t
        sq = lie.quat_normalize(lie.quat_mul(dq, bq))
        st = lie.quat_rotate(dq, bt) + dt
        sp = bp + (np_ - p)
        return bq, bt, bp, bcost, sq, st, sp, lam

    big = jnp.asarray(jnp.inf, jnp.float32)
    q0, t0, p0 = prob.cam_q, prob.cam_t, prob.pts
    bq, bt, bp, bcost, q, t, p, lam = jax.lax.fori_loop(
        0, iters + 1, body,
        (q0, t0, p0, big, q0, t0, p0, jnp.asarray(lam0, jnp.float32)))

    _, inlier = window_cost_and_inliers(prob, kind, bq, bt, bp, chi2_th)
    return WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                        pm_inlier=inlier & mask0, cost=bcost)


# ---------------------------------------------------------------------------
# dense reduced-camera path (single device; no CG)
#
# Layout note: the per-edge math runs in FLAT SoA form — every per-edge
# scalar is its own 1-D [E] array (E = Pw * M), so elementwise chains fuse
# into a few wide kernels.  Small matrices appear only at reduction
# boundaries.  Every matmul there pins ``precision=HIGHEST``: the one-hot
# reductions and the Schur coupling feed a Cholesky, and a TF32 product
# (about three decimal digits) breaks it.
# ---------------------------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST


class _EdgeConsts(NamedTuple):
    """Flattened per-edge constants of a WindowProblem ([E] each)."""

    uvx: jnp.ndarray
    uvy: jnp.ndarray
    w0: jnp.ndarray
    valid: jnp.ndarray
    is_free: jnp.ndarray
    cslot: jnp.ndarray        # clipped free-camera slot
    q0: tuple                 # fixed-observer quat comps (4 x [E])
    t0: tuple                 # fixed-observer translation comps (3 x [E])
    par: tuple                # camera params comps (8 x [E])


def _flatten_consts(prob: WindowProblem) -> _EdgeConsts:
    f = lambda a: a.reshape(-1)
    return _EdgeConsts(
        uvx=f(prob.pm_uv[..., 0]), uvy=f(prob.pm_uv[..., 1]),
        w0=f(prob.pm_w), valid=f(prob.pm_valid),
        is_free=f(prob.pm_cslot >= 0),
        cslot=f(jnp.clip(prob.pm_cslot, 0)),
        q0=tuple(f(prob.pm_q0[..., i]) for i in range(4)),
        t0=tuple(f(prob.pm_t0[..., i]) for i in range(3)),
        par=tuple(f(prob.pm_params0[..., i]) for i in range(8)))


def _soa_rot_from_quat(qw, qx, qy, qz):
    """Rotation-matrix components from a (wxyz) quaternion, SoA."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def _soa_project_and_jac(kind, par, X, Y, Z):
    """(u, v, j00..j12, depth_ok) in SoA form — exactly the math of
    cameras.project_ideal / cameras.project_jac."""
    fx, fy, cx, cy = par[0], par[1], par[2], par[3]
    if kind == cam_mod.PINHOLE:
        z = jnp.where(jnp.abs(Z) < 1e-6, 1e-6, Z)
        iz = 1.0 / z
        iz2 = iz * iz
        u = fx * X * iz + cx
        v = fy * Y * iz + cy
        j00 = fx * iz
        j01 = jnp.zeros_like(X)
        j02 = -fx * X * iz2
        j10 = jnp.zeros_like(X)
        j11 = fy * iz
        j12 = -fy * Y * iz2
    else:  # KANNALA_BRANDT8 (mirrors cameras._project_kb8/_project_jac_kb8)
        k1, k2, k3, k4 = par[4], par[5], par[6], par[7]
        r2 = jnp.maximum(X * X + Y * Y, 1e-18)
        r = jnp.sqrt(r2)
        theta = jnp.arctan2(r, Z)
        t2 = theta * theta
        d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        dd = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2
                                          + t2 * (7.0 * k3
                                                  + 9.0 * k4 * t2)))
        rho2 = r2 + Z * Z
        dth_dx = X * Z / (rho2 * r)
        dth_dy = Y * Z / (rho2 * r)
        dth_dz = -r / rho2
        s = d / r
        ds_dx = (dd * dth_dx * r - d * (X / r)) / r2
        ds_dy = (dd * dth_dy * r - d * (Y / r)) / r2
        ds_dz = dd * dth_dz / r
        u = fx * s * X + cx
        v = fy * s * Y + cy
        j00 = fx * (s + X * ds_dx)
        j01 = fx * X * ds_dy
        j02 = fx * X * ds_dz
        j10 = fy * Y * ds_dx
        j11 = fy * (s + Y * ds_dy)
        j12 = fy * Y * ds_dz
    return u, v, j00, j01, j02, j10, j11, j12, Z > 1e-3


def _soa_linearize(c: _EdgeConsts, kind, cam_q, cam_t, pts, Pw, M):
    """Flat-SoA linearization of every edge.  Returns per-edge residual,
    point-jacobian (2x3), camera-jacobian (2x6, zero on fixed edges) and
    depth mask, all as [E] component arrays."""
    free = c.is_free
    cs = c.cslot
    qw = jnp.where(free, cam_q[:, 0][cs], c.q0[0])
    qx = jnp.where(free, cam_q[:, 1][cs], c.q0[1])
    qy = jnp.where(free, cam_q[:, 2][cs], c.q0[2])
    qz = jnp.where(free, cam_q[:, 3][cs], c.q0[3])
    tx = jnp.where(free, cam_t[:, 0][cs], c.t0[0])
    ty = jnp.where(free, cam_t[:, 1][cs], c.t0[1])
    tz = jnp.where(free, cam_t[:, 2][cs], c.t0[2])
    R = _soa_rot_from_quat(qw, qx, qy, qz)
    px = jnp.broadcast_to(pts[:, 0:1], (Pw, M)).reshape(-1)
    py = jnp.broadcast_to(pts[:, 1:2], (Pw, M)).reshape(-1)
    pz = jnp.broadcast_to(pts[:, 2:3], (Pw, M)).reshape(-1)
    X = R[0] * px + R[1] * py + R[2] * pz + tx
    Y = R[3] * px + R[4] * py + R[5] * pz + ty
    Z = R[6] * px + R[7] * py + R[8] * pz + tz
    u, v, j00, j01, j02, j10, j11, j12, dok = _soa_project_and_jac(
        kind, c.par, X, Y, Z)
    rx = u - c.uvx
    ry = v - c.uvy
    # Jp = dpi @ R  (2x3)
    jp = (j00 * R[0] + j01 * R[3] + j02 * R[6],
          j00 * R[1] + j01 * R[4] + j02 * R[7],
          j00 * R[2] + j01 * R[5] + j02 * R[8],
          j10 * R[0] + j11 * R[3] + j12 * R[6],
          j10 * R[1] + j11 * R[4] + j12 * R[7],
          j10 * R[2] + j11 * R[5] + j12 * R[8])
    # Jc = [dpi | -dpi @ hat(Xc)] (2x6); hat(Xc) rows:
    # [0,-Z,Y],[Z,0,-X],[-Y,X,0], so -(dpi @ hat) columns are
    # (-j1*Z + j2*Y,  j0*Z - j2*X,  -j0*Y + j1*X) per dpi row (j0,j1,j2)
    zf = jnp.where(free, 1.0, 0.0)
    jc = (j00 * zf, j01 * zf, j02 * zf,
          (-j01 * Z + j02 * Y) * zf,
          (j00 * Z - j02 * X) * zf,
          (-j00 * Y + j01 * X) * zf,
          j10 * zf, j11 * zf, j12 * zf,
          (-j11 * Z + j12 * Y) * zf,
          (j10 * Z - j12 * X) * zf,
          (-j10 * Y + j11 * X) * zf)
    return rx, ry, jp, jc, dok

def pm_linearize_all(prob: WindowProblem, kind, cam_q, cam_t, pts):
    """Point-major linearization of EVERY edge (free + fixed cameras in
    one pass): free-cam edges read the live camera state through
    ``pm_cslot``, fixed-cam edges read the stored pose snapshots.  Returns
    r [Pw,M,2], Jp [Pw,M,2,3], Jc [Pw,M,2,6] (zeroed on fixed edges),
    depth_ok."""
    is_free = prob.pm_cslot >= 0
    csl = jnp.clip(prob.pm_cslot, 0)
    q = jnp.where(is_free[..., None], cam_q[csl], prob.pm_q0)
    t = jnp.where(is_free[..., None], cam_t[csl], prob.pm_t0)
    Xc = lie.quat_rotate(q, pts[:, None, :]) + t
    cam = cam_mod.Camera(prob.pm_params0, kind)
    pred = cam_mod.project_ideal(cam, Xc)
    r = pred - prob.pm_uv
    dpi = cam_mod.project_jac(cam, Xc)
    R = lie.quat_to_matrix(q)
    Jp = dpi @ R
    Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)
    Jc = jnp.where(is_free[..., None, None], Jc, 0.0)
    return r, Jp, Jc, Xc[..., 2] > 1e-3


def _lm_iteration_dense(prob: WindowProblem, consts: _EdgeConsts, kind,
                        cam_q, cam_t, pts, lam, edge_mask_flat,
                        huber_delta2, robust):
    """One LM step solving the REDUCED camera system exactly.

    The implicit-Schur CG solver spends ~1 ms per CG matvec on chains of
    small-tensor ops; at window scale (Kc <= ~128 free cameras) the reduced
    system is only [6Kc, 6Kc], so it is far cheaper to FORM it explicitly —
    every reduction is a one-hot matmul — and factor it
    with one dense Cholesky.  Per iteration (SoA, see layout note above):

      Hcc[k]   = sum_e 1[c_e=k] Jc^T W Jc          (one-hot matmul)
      Z[p,k]   = sum_m 1[c_pm=k] Jc^T W Jp         [Pw, Kc, 6, 3]
      coupling = sum_p Z_p Hpp^-1 Z_p^T = (Z L)(Z L)^T   (ONE big matmul)
      H_red    = blockdiag(Hcc) - coupling;  dx_c = chol_solve(H_red, b)
    """
    Pw, M = prob.pm_uv.shape[:2]
    Kc = prob.cam_q.shape[0]
    c = consts

    rx, ry, jp, jc, dok = _soa_linearize(c, kind, cam_q, cam_t, pts,
                                         Pw, M)
    chi2 = c.w0 * (rx * rx + ry * ry)
    active = edge_mask_flat & dok
    cost_here = jnp.sum(jnp.where(active, _rho(chi2, huber_delta2), 0.0))
    w_rob = _huber_w(chi2, huber_delta2) if robust \
        else jnp.ones_like(chi2)
    w = jnp.where(active, c.w0 * w_rob, 0.0)

    def msum(a):  # per-point reduction over the M obs slots
        return jnp.sum(a.reshape(Pw, M), axis=1)

    # g_p [Pw, 3], Hpp [Pw, 3, 3] (6 unique comps)
    wrx, wry = w * rx, w * ry
    g_p = jnp.stack([msum(jp[0] * wrx + jp[3] * wry),
                     msum(jp[1] * wrx + jp[4] * wry),
                     msum(jp[2] * wrx + jp[5] * wry)], axis=-1)
    hpp = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a, 3):
            hpp[a][b] = msum(w * (jp[a] * jp[b] + jp[3 + a] * jp[3 + b]))
    Hpp = jnp.stack(
        [jnp.stack([hpp[0][0], hpp[0][1], hpp[0][2]], -1),
         jnp.stack([hpp[0][1], hpp[1][1], hpp[1][2]], -1),
         jnp.stack([hpp[0][2], hpp[1][2], hpp[2][2]], -1)], -2)

    # per-edge camera-block columns, stacked for ONE one-hot matmul:
    # 6 gradient comps + 21 unique Hcc comps -> [E, 27]
    cols = [jc[a] * wrx + jc[6 + a] * wry for a in range(6)]
    tri = []
    for a in range(6):
        for b in range(a, 6):
            tri.append(w * (jc[a] * jc[b] + jc[6 + a] * jc[6 + b]))
    S_e = jnp.stack(cols + tri, axis=-1)                   # [E, 27]
    O = ((c.cslot[:, None] == jnp.arange(Kc, dtype=jnp.int32))
         & c.is_free[:, None]).astype(jnp.float32)         # [E, Kc]
    red = jnp.matmul(O.T, S_e, precision=_HI)              # [Kc, 27]
    g_c = red[:, :6]
    iu = jnp.asarray(
        [[0, 1, 2, 3, 4, 5], [1, 6, 7, 8, 9, 10], [2, 7, 11, 12, 13, 14],
         [3, 8, 12, 15, 16, 17], [4, 9, 13, 16, 18, 19],
         [5, 10, 14, 17, 19, 20]], jnp.int32)
    Hcc = red[:, 6:][:, iu]                                # [Kc, 6, 6]

    # Wblk (Jc^T W Jp, 18 comps) -> Z[p, k, a, b] via batched matmul
    wb = [w * (jc[a] * jp[b] + jc[6 + a] * jp[3 + b])
          for a in range(6) for b in range(3)]
    Wstack = jnp.stack(wb, axis=-1)                        # [E, 18]
    Z = jnp.einsum("pmk,pmj->pkj", O.reshape(Pw, M, Kc),
                   Wstack.reshape(Pw, M, 18),
                   precision=_HI).reshape(Pw, Kc, 6, 3)

    def damp(H, free, dim):
        diag = jnp.diagonal(H, axis1=-2, axis2=-1)
        add = lam * jnp.maximum(diag, 1e-6) + 1e-8
        H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
        return jnp.where(free[:, None, None], H,
                         jnp.eye(dim, dtype=H.dtype))

    Hcc_l = damp(Hcc, prob.cam_valid, 6)
    Hpp_inv = _spd_inv3(damp(Hpp, prob.pt_valid, 3))

    # explicit Schur coupling via one big matmul
    L = _chol3(Hpp_inv)                                    # [Pw, 3, 3]
    Zl = jnp.einsum("pkab,pbc->pkac", Z, L, precision=_HI)
    Zf = Zl.transpose(0, 3, 1, 2).reshape(Pw * 3, Kc * 6)
    C = jnp.matmul(Zf.T, Zf, precision=_HI)                # [6Kc, 6Kc]

    ii = jnp.arange(Kc)
    H_red = (-C).reshape(Kc, 6, Kc, 6).at[ii, :, ii, :].add(
        Hcc_l, unique_indices=True).reshape(Kc * 6, Kc * 6)
    z0 = jnp.einsum("pab,pb->pa", Hpp_inv, g_p, precision=_HI)
    b = -g_c + jnp.einsum("pkab,pb->ka", Z, z0,
                          precision=_HI)                   # [Kc, 6]

    chol = jax.scipy.linalg.cho_factor(H_red)
    dx = jax.scipy.linalg.cho_solve(chol, b.reshape(-1)).reshape(Kc, 6)
    dx_c = jnp.where(prob.cam_valid[:, None], dx, 0.0)
    dx_c = jnp.where(jnp.all(jnp.isfinite(dx_c)), dx_c, 0.0)

    # point back-substitution: u_b = sum_m Wblk[a,b] dxc[cslot][a]
    vc = [dx_c[:, a][c.cslot] for a in range(6)]           # 6 x [E]
    u = jnp.stack(
        [msum(sum(wb[a * 3 + b0] * vc[a] for a in range(6)))
         for b0 in range(3)], axis=-1)                     # [Pw, 3]
    dx_p = jnp.einsum("pab,pb->pa", Hpp_inv, -g_p - u, precision=_HI)
    dx_p = jnp.where(prob.pt_valid[:, None], dx_p, 0.0)
    dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)

    dT = lie.se3_exp(dx_c)
    new_q = lie.quat_normalize(lie.quat_mul(dT.q, cam_q))
    new_t = lie.quat_rotate(dT.q, cam_t) + dT.t
    return new_q, new_t, pts + dx_p, cost_here


def run_window_ba_dense(prob: WindowProblem, kind: int, iters: int = 10,
                        huber_delta2: float = CHI2_MONO,
                        robust: bool = True, chi2_th: float = CHI2_MONO,
                        pm_edge_mask=None,
                        lam0: float = 1e-4) -> WindowResult:
    """LM loop on the dense reduced-camera solver — the single-chip hot
    path (local BA / welding BA / global BA).  Same accept/reject scheme
    as ``run_window_ba``; the final cost/inlier pass reuses the pm-only
    linearization so the camera-major view is never touched (problems may
    be built with ``with_cm=False``)."""
    mask0 = prob.pm_valid if pm_edge_mask is None \
        else (prob.pm_valid & pm_edge_mask)
    consts = _flatten_consts(prob)
    mask0_flat = mask0.reshape(-1)
    Pw, M = prob.pm_uv.shape[:2]

    def final_cost_inliers(q, t, p):
        rx, ry, _, _, dok = _soa_linearize(consts, kind, q, t, p, Pw, M)
        chi2 = consts.w0 * (rx * rx + ry * ry)
        active = consts.valid & dok
        inlier = active & (chi2 < chi2_th)
        return inlier.reshape(Pw, M)

    def body(_, carry):
        bq, bt, bp, bcost, q, t, p, lam = carry
        nq, nt, np_, cost = _lm_iteration_dense(
            prob, consts, kind, q, t, p, lam, mask0_flat, huber_delta2,
            robust)
        accept = cost < bcost
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                        jnp.minimum(lam * 4.0, 1e4))
        bq = jnp.where(accept, q, bq)
        bt = jnp.where(accept, t, bt)
        bp = jnp.where(accept, p, bp)
        bcost = jnp.where(accept, cost, bcost)
        dq = lie.quat_mul(nq, lie.quat_conj(q))
        dt = nt - lie.quat_rotate(dq, t)
        sq = lie.quat_normalize(lie.quat_mul(dq, bq))
        st = lie.quat_rotate(dq, bt) + dt
        sp = bp + (np_ - p)
        return bq, bt, bp, bcost, sq, st, sp, lam

    big = jnp.asarray(jnp.inf, jnp.float32)
    q0, t0, p0 = prob.cam_q, prob.cam_t, prob.pts
    bq, bt, bp, bcost, q, t, p, lam = jax.lax.fori_loop(
        0, iters + 1, body,
        (q0, t0, p0, big, q0, t0, p0, jnp.asarray(lam0, jnp.float32)))
    inlier = final_cost_inliers(bq, bt, bp)
    return WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                        pm_inlier=inlier & mask0, cost=bcost)

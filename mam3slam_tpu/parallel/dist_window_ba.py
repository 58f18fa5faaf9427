"""Distributed dense window BA: owner-partitioned Schur over a mesh.

Multi-device form of ``solvers/ba_window.py`` (SURVEY.md §2.6 "BA
reductions -> psum", §2.8 "Schur-block parallelism"; BASELINE.md 4-agent /
2-host scaling target).  The round-2 edge-sharded solver replicated ALL
vertex state and psum'd arena-sized arrays every CG step — every device
re-did the per-point Schur elimination, so adding devices added work.
Here the partition follows the data:

* **points are owner-partitioned** along the mesh axis: each device holds
  ``Pw/n`` points with their point-major observation rows and performs
  their 3x3 Schur elimination (``Hpp``, ``g_p``, ``Hpp^-1``) exactly once.
* **cameras are sharded for edge work, replicated for state**: the
  camera-major edge grid is split row-wise, so ``Hcc``/``g_c``/``W z``
  reductions are local; the (tiny) ``[Kc, 6]`` camera vectors of the CG
  iteration are replicated so control flow is identical on every device.
* free-camera edges are linearized twice (once by the camera's owner for
  the reduced system, once by the point's owner for the elimination) —
  the standard halo duplication; both start from bit-identical replicated
  camera state and the all-gathered point block.

Communication per CG iteration: ``all_gather`` of ``z`` (``[Pw, 3]``, the
eliminated point increments) and of the partial Schur products
(``[Kc, 6]``).  Per LM iteration: ``all_gather`` of the point block +
``Hpp^-1`` and a scalar ``psum`` for the robust cost.  Everything else is
local — per-device work is O(E/n + Pw/n + Kc), so the total work stays
constant as devices are added (the round-2 solver's was O(E/n + Pw + Kc)
per device *per CG step*).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mam3slam_tpu.geometry import lie
from mam3slam_tpu.solvers import ba_window as bw

CHI2 = bw.CHI2_MONO


# ---------------------------------------------------------------------------
# edge list -> WindowProblem (host-side; for drivers/tests that have a
# BAProblem-style edge list rather than a MapState)
# ---------------------------------------------------------------------------

def window_problem_from_edges(cam_q, cam_t, cam_params, pts, obs_cam,
                              obs_pt, obs_uv, obs_w, cam_free, pt_free,
                              max_obs: int = 24, feat_cap: int = None,
                              compact_free: bool = False):
    """Group a flat observation list into the dense two-view layout.

    Host-side numpy (problem construction, not the hot path).  By default
    cameras keep their index (all cams are "in window"; fixed = not in
    cam_free).  With ``compact_free=True`` the camera block holds ONLY the
    free cameras (Kc = #free) — fixed observers appear solely through the
    point-major pose snapshots — which shrinks the dense distributed
    solver's psum payload ((6 Kc)^2) and its replicated Cholesky.
    """
    K = np.asarray(cam_q).shape[0]
    Pn = np.asarray(pts).shape[0]
    oc = np.asarray(obs_cam)
    op = np.asarray(obs_pt)
    ouv = np.asarray(obs_uv, np.float32)
    ow = np.asarray(obs_w, np.float32)
    cam_free = np.asarray(cam_free)
    pt_free = np.asarray(pt_free)
    E = oc.shape[0]

    if compact_free:
        rows = np.flatnonzero(cam_free)              # camera-block rows
        slot_of = np.full(K, -1, np.int32)
        slot_of[rows] = np.arange(len(rows), dtype=np.int32)
    else:
        rows = np.arange(K)
        slot_of = np.where(cam_free, np.arange(K, dtype=np.int32),
                           -1).astype(np.int32)
    Kr = len(rows)
    in_cm = slot_of[oc] >= 0 if compact_free \
        else np.ones(E, bool)                        # edges in the cm grid

    # per-camera-row feature lists
    order_c = np.argsort(oc, kind="stable")
    F = feat_cap or max(1, int(np.bincount(
        oc[in_cm] if compact_free else oc, minlength=K).max()))
    cm_pt = np.full((Kr, F), -1, np.int32)
    cm_uv = np.zeros((Kr, F, 2), np.float32)
    cm_w = np.ones((Kr, F), np.float32)
    feat_of_edge = np.zeros(E, np.int32)
    fill = np.zeros(Kr, np.int32)
    for e in order_c:
        s = slot_of[oc[e]] if compact_free else oc[e]
        if s < 0:
            continue
        f = fill[s]
        if f >= F:
            continue
        cm_pt[s, f] = op[e]
        cm_uv[s, f] = ouv[e]
        cm_w[s, f] = ow[e]
        feat_of_edge[e] = f
        fill[s] = f + 1

    # per-point observation lists
    M = max_obs
    pm_kf = np.full((Pn, M), -1, np.int32)
    pm_feat = np.full((Pn, M), -1, np.int32)
    pm_uv = np.zeros((Pn, M, 2), np.float32)
    pm_w = np.ones((Pn, M), np.float32)
    pm_mslot_of_edge = np.zeros(E, np.int32)
    pfill = np.zeros(Pn, np.int32)
    for e in np.argsort(op, kind="stable"):
        p = op[e]
        m = pfill[p]
        if m >= M:
            continue
        pm_kf[p, m] = oc[e]
        pm_feat[p, m] = feat_of_edge[e]
        pm_uv[p, m] = ouv[e]
        pm_w[p, m] = ow[e]
        pm_mslot_of_edge[e] = m
        pfill[p] = m + 1

    pm_valid = pm_kf >= 0
    cam_slot_of = slot_of
    pm_cslot = np.where(pm_valid,
                        slot_of[np.clip(pm_kf, 0, None)],
                        -1).astype(np.int32)

    # cm <-> pm bridge
    cm_mslot = np.zeros((Kr, F), np.int32)
    cm_valid = np.zeros((Kr, F), bool)
    for e in range(E):
        s = slot_of[oc[e]] if compact_free else oc[e]
        if s < 0:
            continue
        f = feat_of_edge[e]
        if cm_pt[s, f] == op[e]:
            cm_mslot[s, f] = pm_mslot_of_edge[e]
            cm_valid[s, f] = pm_mslot_of_edge[e] < M and \
                pm_kf[op[e], pm_mslot_of_edge[e]] == oc[e]
    cm_valid &= cam_free[rows][:, None] & (cm_pt >= 0)

    j = jnp.asarray
    return bw.WindowProblem(
        cam_idx=j(np.where(cam_free[rows], rows, -1).astype(np.int32)),
        cam_valid=j(cam_free[rows]),
        cam_q=j(np.asarray(cam_q, np.float32)[rows]),
        cam_t=j(np.asarray(cam_t, np.float32)[rows]),
        cam_params=j(np.asarray(cam_params, np.float32)[rows]),
        cm_uv=j(cm_uv), cm_w=j(cm_w), cm_pt=j(cm_pt),
        cm_mslot=j(cm_mslot), cm_valid=j(cm_valid),
        pt_idx=j(np.arange(Pn, dtype=np.int32)),
        pt_valid=j(pt_free.astype(bool)),
        pts=j(np.asarray(pts, np.float32)),
        pm_kf=j(pm_kf), pm_feat=j(pm_feat), pm_cslot=j(pm_cslot),
        pm_uv=j(pm_uv), pm_w=j(pm_w), pm_valid=j(pm_valid),
        pm_q0=j(np.asarray(cam_q, np.float32)[np.clip(pm_kf, 0, None)]),
        pm_t0=j(np.asarray(cam_t, np.float32)[np.clip(pm_kf, 0, None)]),
        pm_params0=j(np.asarray(cam_params, np.float32)[
            np.clip(pm_kf, 0, None)]),
        cam_slot_of=j(cam_slot_of),
        pt_slot_of=j(np.arange(Pn, dtype=np.int32)))


def _pad_rows(x, n):
    pad = (-x.shape[0]) % n
    if pad == 0:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def pad_problem(prob: bw.WindowProblem, n: int) -> bw.WindowProblem:
    """Pad camera and point axes to multiples of the mesh size (padding
    rows are invalid and inert)."""
    d = prob._asdict()
    for k in ("cam_idx", "cam_valid", "cam_q", "cam_t", "cam_params",
              "cm_uv", "cm_w", "cm_pt", "cm_mslot", "cm_valid"):
        d[k] = _pad_rows(d[k], n)
    for k in ("pt_idx", "pt_valid", "pts", "pm_kf", "pm_feat", "pm_cslot",
              "pm_uv", "pm_w", "pm_valid", "pm_q0", "pm_t0", "pm_params0"):
        d[k] = _pad_rows(d[k], n)
    # padded cam_idx rows must be invalid
    d["cam_idx"] = jnp.where(d["cam_valid"], d["cam_idx"], -1)
    d["pt_idx"] = jnp.where(d["pt_valid"], d["pt_idx"], -1)
    return bw.WindowProblem(**d)


# ---------------------------------------------------------------------------
# distributed solver
# ---------------------------------------------------------------------------

def _pm_linearize_all(prob, kind, cam_q_rep, cam_t_rep, pts_local):
    """Point-major linearization of the LOCAL point shard: free-cam edges
    from the replicated camera state, fixed-cam edges from the stored
    snapshots.  Returns r, Jp, Jc((zeroed for fixed)), depth_ok."""
    from mam3slam_tpu.geometry import cameras as cam_mod

    is_free = prob.pm_cslot >= 0
    csl = jnp.clip(prob.pm_cslot, 0)
    q = jnp.where(is_free[..., None], cam_q_rep[csl], prob.pm_q0)
    t = jnp.where(is_free[..., None], cam_t_rep[csl], prob.pm_t0)
    Xc = lie.quat_rotate(q, pts_local[:, None, :]) + t
    cam = cam_mod.Camera(prob.pm_params0, kind)
    pred = cam_mod.project_ideal(cam, Xc)
    r = pred - prob.pm_uv
    dpi = cam_mod.project_jac(cam, Xc)
    R = lie.quat_to_matrix(q)
    Jp = dpi @ R
    Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)
    Jc = jnp.where(is_free[..., None, None], Jc, 0.0)
    depth_ok = Xc[..., 2] > 1e-3
    return r, Jp, Jc, depth_ok


def dist_run_window_ba(prob: bw.WindowProblem, mesh: Mesh, kind: int,
                       axis: str = "shard", iters: int = 10,
                       cg_iters: int = 30, huber_delta2: float = CHI2,
                       robust: bool = True,
                       chi2_th: float = CHI2) -> bw.WindowResult:
    """Owner-partitioned distributed LM over ``mesh[axis]``.  The jitted
    shard_map program is cached per (mesh, shapes, params) — repeated
    calls pay zero retracing."""
    n = mesh.shape[axis]
    prob = pad_problem(prob, n)
    runner = _make_runner(mesh, kind, axis, iters, cg_iters,
                          float(huber_delta2), bool(robust),
                          float(chi2_th), prob.cam_q.shape[0],
                          prob.pts.shape[0])
    return runner(prob)


@functools.lru_cache(maxsize=None)
def _make_runner(mesh: Mesh, kind: int, axis: str, iters: int,
                 cg_iters: int, huber_delta2: float, robust: bool,
                 chi2_th: float, Kc: int, Pw: int):
    n = mesh.shape[axis]
    Kn = Kc // n

    shard0 = P(axis)
    repl = P()
    in_specs = bw.WindowProblem(
        cam_idx=shard0, cam_valid=shard0,
        cam_q=repl, cam_t=repl, cam_params=shard0,
        cm_uv=shard0, cm_w=shard0, cm_pt=shard0, cm_mslot=shard0,
        cm_valid=shard0,
        pt_idx=shard0, pt_valid=shard0, pts=shard0,
        pm_kf=shard0, pm_feat=shard0, pm_cslot=shard0,
        pm_uv=shard0, pm_w=shard0, pm_valid=shard0,
        pm_q0=shard0, pm_t0=shard0, pm_params0=shard0,
        cam_slot_of=repl, pt_slot_of=repl)
    out_specs = bw.WindowResult(cam_q=repl, cam_t=repl, pts=shard0,
                                pm_inlier=shard0, cost=repl)

    def agather(x):
        return jax.lax.all_gather(x, axis, tiled=True)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(in_specs,),
                       out_specs=out_specs, check_vma=False)
    def _run(lp: bw.WindowProblem):
        from mam3slam_tpu.geometry import cameras as cam_mod

        my = jax.lax.axis_index(axis)

        def cm_linearize(cam_q_rep, cam_t_rep, pts_full):
            """Local camera-shard linearization (rows my*Kn .. +Kn)."""
            q = jax.lax.dynamic_slice_in_dim(cam_q_rep, my * Kn, Kn)
            t = jax.lax.dynamic_slice_in_dim(cam_t_rep, my * Kn, Kn)
            X = pts_full[jnp.clip(lp.cm_pt, 0)]
            Xc = lie.quat_rotate(q[:, None, :], X) + t[:, None, :]
            cam = cam_mod.Camera(lp.cam_params[:, None, :], kind)
            pred = cam_mod.project_ideal(cam, Xc)
            r = pred - lp.cm_uv
            dpi = cam_mod.project_jac(cam, Xc)
            Jc = jnp.concatenate([dpi, -dpi @ lie.hat(Xc)], axis=-1)
            R = lie.quat_to_matrix(q)
            Jp = dpi @ R[:, None]
            return r, Jc, Jp, Xc[..., 2] > 1e-3

        def cost_inlier(cam_q_rep, cam_t_rep, pts_local):
            r, _, _, dok = _pm_linearize_all(lp, kind, cam_q_rep,
                                             cam_t_rep, pts_local)
            chi2 = lp.pm_w * jnp.sum(r * r, axis=-1)
            active = lp.pm_valid & dok
            c = jax.lax.psum(
                jnp.sum(jnp.where(active, bw._rho(chi2, chi2_th), 0.0)),
                axis)
            return c, active & (chi2 < chi2_th)

        def lm_iter(cam_q_rep, cam_t_rep, pts_local, lam):
            pts_full = agather(pts_local)
            # --- point-owner side: elimination blocks
            r_pm, Jp_pm, Jc_pm, dok_pm = _pm_linearize_all(
                lp, kind, cam_q_rep, cam_t_rep, pts_local)
            chi2 = lp.pm_w * jnp.sum(r_pm * r_pm, axis=-1)
            cost_here = jax.lax.psum(
                jnp.sum(jnp.where(lp.pm_valid & dok_pm,
                                  bw._rho(chi2, huber_delta2), 0.0)), axis)
            w_rob = bw._huber_w(chi2, huber_delta2) if robust \
                else jnp.ones_like(chi2)
            w_pm = jnp.where(lp.pm_valid & dok_pm, lp.pm_w * w_rob, 0.0)
            wJp = Jp_pm * w_pm[..., None, None]
            g_p = jnp.einsum("pmij,pmi->pj", wJp, r_pm)
            Hpp = jnp.einsum("pmia,pmib->pab", wJp, Jp_pm)
            W_pm = jnp.einsum("pmia,pmib->pmab",
                              Jc_pm * w_pm[..., None, None], Jp_pm)

            def damp(H, free, dim):
                diag = jnp.diagonal(H, axis1=-2, axis2=-1)
                add = lam * jnp.maximum(diag, 1e-6) + 1e-8
                H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
                return jnp.where(free[:, None, None], H,
                                 jnp.eye(dim, dtype=H.dtype))

            Hpp_inv = bw._spd_inv3(damp(Hpp, lp.pt_valid, 3))
            Hpp_inv_full = agather(Hpp_inv)

            # --- camera-owner side: reduced system blocks
            r_cm, Jc_cm, Jp_cm, dok_cm = cm_linearize(
                cam_q_rep, cam_t_rep, pts_full)
            chi2_cm = lp.cm_w * jnp.sum(r_cm * r_cm, axis=-1)
            w_rob_cm = bw._huber_w(chi2_cm, huber_delta2) if robust \
                else jnp.ones_like(chi2_cm)
            w_cm = jnp.where(lp.cm_valid & dok_cm,
                             lp.cm_w * w_rob_cm, 0.0)
            wJc = Jc_cm * w_cm[..., None, None]
            g_c_n = jnp.einsum("kfij,kfi->kj", wJc, r_cm)
            Hcc_n = jnp.einsum("kfia,kfib->kab", wJc, Jc_cm)
            W_cm = jnp.einsum("kfia,kfib->kfab", wJc, Jp_cm)
            Hcc_l_n = damp(Hcc_n, lp.cam_valid, 6)

            ptc = jnp.clip(lp.cm_pt, 0)
            WHW = jnp.einsum("kfab,kfbc,kfdc->kad", W_cm,
                             Hpp_inv_full[ptc], W_cm)
            M_inv_n = bw._spd_inv6(Hcc_l_n - WHW)

            # RHS: b = -g_c + W Hpp^-1 g_p   (cam-sharded, then gathered)
            z0 = jnp.einsum("pab,pb->pa", Hpp_inv, g_p)
            z0_full = agather(z0)
            b_n = -g_c_n + jnp.einsum("kfab,kfb->ka", W_cm, z0_full[ptc])
            b = agather(b_n)

            def S_mv(v):
                # point-owner half: u = W^T v, z = Hpp^-1 u
                vc = v[jnp.clip(lp.pm_cslot, 0)]
                u = jnp.einsum("pmab,pma->pb", W_pm, vc)
                z = jnp.einsum("pab,pb->pa", Hpp_inv, u)
                z_full = agather(z)
                # camera-owner half: Hcc v - W z
                v_n = jax.lax.dynamic_slice_in_dim(v, my * Kn, Kn)
                back = jnp.einsum("kfab,kfb->ka", W_cm, z_full[ptc])
                Sv_n = jnp.einsum("kab,kb->ka", Hcc_l_n, v_n) - back
                return agather(Sv_n)

            def precond(v):
                v_n = jax.lax.dynamic_slice_in_dim(v, my * Kn, Kn)
                return agather(jnp.einsum("kab,kb->ka", M_inv_n, v_n))

            x = jnp.zeros_like(b)
            rr = b - S_mv(x)
            zz = precond(rr)
            p = zz
            rz = jnp.sum(rr * zz)

            def cg_body(_, carry):
                x, rr, p, rz = carry
                Sp = S_mv(p)
                den = jnp.sum(p * Sp)
                alpha = rz / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
                x = x + alpha * p
                rr = rr - alpha * Sp
                zz = precond(rr)
                rz_new = jnp.sum(rr * zz)
                beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
                return x, rr, zz + beta * p, rz_new

            x, rr, p, rz = jax.lax.fori_loop(0, cg_iters, cg_body,
                                             (x, rr, p, rz))
            cam_valid_rep = agather(lp.cam_valid)
            dx_c = jnp.where(cam_valid_rep[:, None], x, 0.0)

            # point back-substitution (local)
            vc = dx_c[jnp.clip(lp.pm_cslot, 0)]
            u = jnp.einsum("pmab,pma->pb", W_pm, vc)
            dx_p = jnp.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
            dx_p = jnp.where(lp.pt_valid[:, None], dx_p, 0.0)

            dT = lie.se3_exp(dx_c)
            nq = lie.quat_normalize(lie.quat_mul(dT.q, cam_q_rep))
            nt = lie.quat_rotate(dT.q, cam_t_rep) + dT.t
            return nq, nt, pts_local + dx_p, cost_here

        def body(_, carry):
            bq, bt, bp, bcost, q, t, p, lam = carry
            nq, nt, np_, cost = lm_iter(q, t, p, lam)
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
        q0, t0, p0 = lp.cam_q, lp.cam_t, lp.pts
        bq, bt, bp, bcost, _, _, _, _ = jax.lax.fori_loop(
            0, iters + 1, body,
            (q0, t0, p0, big, q0, t0, p0,
             jnp.asarray(1e-4, jnp.float32)))
        _, inlier = cost_inlier(bq, bt, bp)
        return bw.WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                               pm_inlier=inlier, cost=bcost)

    return jax.jit(_run)


# ---------------------------------------------------------------------------
# distributed DENSE reduced-camera solver — ONE psum per LM iteration
# ---------------------------------------------------------------------------

def dist_run_window_ba_dense(prob: bw.WindowProblem, mesh: Mesh, kind: int,
                             axis: str = "shard", iters: int = 10,
                             huber_delta2: float = CHI2,
                             robust: bool = True,
                             chi2_th: float = CHI2) -> bw.WindowResult:
    """Distributed form of ``bw.run_window_ba_dense`` (the production
    single-chip LBA/GBA solver): points + their point-major edges are
    owner-partitioned along ``mesh[axis]``; camera state is replicated.

    Per LM iteration each device

    1. linearizes its LOCAL edge shard (flat SoA),
    2. eliminates its LOCAL points (3x3 ``Hpp^-1`` — done exactly once
       per point across the mesh),
    3. forms its shard of the reduced camera system with local one-hot
       matmuls: ``red = O^T S_e`` ([Kc, 27] grad+Hcc comps) and the Schur
       coupling ``C = (Z L)(Z L)^T`` ([6Kc, 6Kc]),
    4. contributes to ONE ``psum`` of the packed
       ``(C, red, b_z, cost)`` buffer — the iteration's only collective,
    5. solves the (replicated, tiny: 6 Kc <= ~1.5k) reduced system with a
       dense Cholesky and back-substitutes its local points.

    vs ``dist_run_window_ba`` (implicit-Schur CG): that path pays 2
    ``all_gather`` per CG matvec (~60 collectives per LM iteration);
    latency-dominated on small messages, it stopped scaling past 2
    devices (measured on a virtual CPU mesh).  Here communication per LM
    iteration is one fused ~(6Kc)^2-float reduction regardless of edge
    count, so per-device work is O(E/n + Pw/n + Kc^2) with an O(Kc^3)
    replicated Cholesky tail (Amdahl term; negligible for Kc <= 256).
    Reference mapping: SURVEY §2.6 "BA reductions -> psum" (g2o's
    single-threaded sparse LM, src/Optimizer.cc:1116)."""
    n = mesh.shape[axis]
    prob = pad_problem(prob, n)
    runner = _make_dense_runner(mesh, kind, axis, iters,
                                float(huber_delta2), bool(robust),
                                float(chi2_th), prob.cam_q.shape[0],
                                prob.pts.shape[0], prob.pm_uv.shape[1])
    return runner(prob)


# ---------------------------------------------------------------------------
# owner-partitioned implicit-Schur CG — ONE [Kc, 6] psum per CG matvec
# ---------------------------------------------------------------------------


class PsumShardProblem(NamedTuple):
    """Device-stacked window-BA problem for ``dist_run_window_ba_psum``.

    Replicated camera block + point shards stacked along axis 0 in
    device-major order (device d owns rows [d*Pl, (d+1)*Pl)), plus a
    per-device LOCAL camera-major gather grid ``cm_src`` [n*Kc, F_l]
    mapping (camera, slot) -> flat local edge index (p_loc*M + m) or -1.
    ``pt_perm`` (host-side) restores the original point order."""

    cam_q: jnp.ndarray        # [Kc, 4]   replicated
    cam_t: jnp.ndarray        # [Kc, 3]   replicated
    cam_params: jnp.ndarray   # [Kc, 8]   replicated
    cam_valid: jnp.ndarray    # [Kc]      replicated
    pts: jnp.ndarray          # [n*Pl, 3]
    pt_valid: jnp.ndarray     # [n*Pl]
    pm_cslot: jnp.ndarray     # [n*Pl, M]
    pm_uv: jnp.ndarray        # [n*Pl, M, 2]
    pm_w: jnp.ndarray         # [n*Pl, M]
    pm_valid: jnp.ndarray     # [n*Pl, M]
    pm_q0: jnp.ndarray        # [n*Pl, M, 4]
    pm_t0: jnp.ndarray        # [n*Pl, M, 3]
    pm_params0: jnp.ndarray   # [n*Pl, M, 8]
    cm_src: jnp.ndarray       # [n*Kc, F_l]


def shard_problem_for_psum(prob: bw.WindowProblem, n: int):
    """Host-side partition of a WindowProblem for the psum-CG solver.

    Points are dealt round-robin to the ``n`` devices (strided, for edge
    balance), then each device's free-camera edges are grouped by camera
    into the local [Kc, F_l] gather grid.  Returns
    ``(PsumShardProblem, inv_perm)`` where ``inv_perm`` maps shard-order
    point rows back to the original order."""
    Pw = int(prob.pts.shape[0])
    Kc = int(prob.cam_q.shape[0])
    M = int(prob.pm_uv.shape[1])
    Pl = -(-Pw // n)
    # strided deal: device d owns original points d::n
    perm = np.argsort(np.arange(Pw) % n, kind="stable").astype(np.int32)
    perm_full = np.concatenate(
        [perm, np.arange(Pw, n * Pl, dtype=np.int32)])  # pad rows absent

    def take(a):
        a = np.asarray(a)
        out = np.zeros((n * Pl,) + a.shape[1:], a.dtype)
        out[:Pw] = a[perm]
        return out

    pm_cslot = take(prob.pm_cslot)
    pm_valid = take(prob.pm_valid)
    # per-device [Kc] edge lists
    counts = np.zeros((n, Kc), np.int64)
    dev_of = np.repeat(np.arange(n), Pl)
    free = pm_valid & (pm_cslot >= 0)
    p_idx, m_idx = np.nonzero(free)
    d_idx = dev_of[p_idx]
    k_idx = pm_cslot[p_idx, m_idx]
    np.add.at(counts, (d_idx, k_idx), 1)
    F_l = max(8, int(-(-counts.max() // 8) * 8))
    cm_src = np.full((n, Kc, F_l), -1, np.int32)
    fill = np.zeros((n, Kc), np.int32)
    loc = (p_idx % Pl) * M + m_idx
    for d, k, e in zip(d_idx, k_idx, loc):
        cm_src[d, k, fill[d, k]] = e
        fill[d, k] += 1

    j = jnp.asarray
    sp = PsumShardProblem(
        cam_q=prob.cam_q, cam_t=prob.cam_t, cam_params=prob.cam_params,
        cam_valid=prob.cam_valid,
        pts=j(take(prob.pts)), pt_valid=j(take(prob.pt_valid)),
        pm_cslot=j(pm_cslot), pm_uv=j(take(prob.pm_uv)),
        pm_w=j(take(prob.pm_w)), pm_valid=j(pm_valid),
        pm_q0=j(take(prob.pm_q0)), pm_t0=j(take(prob.pm_t0)),
        pm_params0=j(take(prob.pm_params0)),
        cm_src=j(cm_src.reshape(n * Kc, F_l)))
    inv_perm = np.empty(Pw, np.int32)
    inv_perm[perm] = np.arange(Pw, dtype=np.int32)
    return sp, jnp.asarray(inv_perm)


def dist_run_window_ba_psum(prob: bw.WindowProblem, mesh: Mesh, kind: int,
                            axis: str = "shard", iters: int = 10,
                            cg_iters: int = 30,
                            huber_delta2: float = CHI2,
                            robust: bool = True,
                            chi2_th: float = CHI2) -> bw.WindowResult:
    """Owner-partitioned implicit-Schur PCG — the production distributed
    GLOBAL-BA path (``dist_solve_window_ba`` picks it when the free-camera
    count is large; small windows use the dense one-psum solver).

    Each device owns ``Pw/n`` points with ALL their edges, in two local
    views: point-major [Pl, M] (flat SoA) for the 3x3 eliminations and
    ``W^T v``, and a local camera-major gather grid [Kc, F_l] over the
    same edges for the per-camera reductions.  Camera state ([Kc, 6]
    vectors — tiny) is replicated, so CG control flow is identical on
    every device.  Communication:

    * per LM iteration: ONE packed psum of the per-camera partials
      (g_c 6 + Hcc 21 + Schur-diag 21 + W z0 6 comps + cost) —
      ``(54 Kc + 1) * 4`` bytes;
    * per CG matvec: ONE psum of the ``W Hpp^-1 W^T v`` partial —
      ``24 Kc`` bytes.

    Total payload per LM iteration = ``4 (54 Kc + 1) + 24 Kc (cg + 1)``
    bytes — LINEAR in camera count (the dense path's is quadratic:
    ``4 (6 Kc)^2``), with no replicated O((6Kc)^3) factorization.
    Per-device compute is O(E/n + Pw/n + Kc) per matvec.  vs
    ``dist_run_window_ba`` (camera-sharded CG): that path all_gathers the
    [Pw, 3] point increments every matvec (O(Pw) bytes, 2 collectives);
    here the point halves never leave their owner.  Reference mapping:
    SURVEY §2.6 "BA reductions -> psum"; g2o's single-threaded sparse LM
    (/root/reference/src/Optimizer.cc:1116)."""
    n = mesh.shape[axis]
    sp, inv_perm = shard_problem_for_psum(prob, n)
    runner = _make_psum_runner(mesh, kind, axis, iters, cg_iters,
                               float(huber_delta2), bool(robust),
                               float(chi2_th), int(sp.cam_q.shape[0]),
                               int(sp.pts.shape[0]),
                               int(sp.pm_uv.shape[1]),
                               int(sp.cm_src.shape[1]))
    res = runner(sp)
    # restore original point order (shards are strided-permuted)
    return bw.WindowResult(
        cam_q=res.cam_q, cam_t=res.cam_t,
        pts=res.pts[inv_perm], pm_inlier=res.pm_inlier[inv_perm],
        cost=res.cost)


def dist_solve_window_ba(prob: bw.WindowProblem, mesh: Mesh, kind: int,
                         axis: str = "shard", iters: int = 10,
                         cg_iters: int = 30, dense_free_cap: int = 32,
                         **kw) -> bw.WindowResult:
    """Production dispatcher: dense one-psum solver for small windows
    (exact 6Kc Cholesky, one collective per LM iteration — right when
    ``(6 Kc)^2`` is small), psum-CG for global-BA-sized camera counts
    (payload linear in Kc)."""
    n_free = int(jnp.sum(prob.cam_valid))
    if n_free <= dense_free_cap:
        return dist_run_window_ba_dense(prob, mesh, kind, axis=axis,
                                        iters=iters, **kw)
    return dist_run_window_ba_psum(prob, mesh, kind, axis=axis,
                                   iters=iters, cg_iters=cg_iters, **kw)


@functools.lru_cache(maxsize=None)
def _make_psum_runner(mesh: Mesh, kind: int, axis: str, iters: int,
                      cg_iters: int, huber_delta2: float, robust: bool,
                      chi2_th: float, Kc: int, Pn: int, M: int, F_l: int):
    n = mesh.shape[axis]
    Pl = Pn // n
    E_l = Pl * M

    shard0 = P(axis)
    repl = P()
    in_specs = PsumShardProblem(
        cam_q=repl, cam_t=repl, cam_params=repl, cam_valid=repl,
        pts=shard0, pt_valid=shard0, pm_cslot=shard0, pm_uv=shard0,
        pm_w=shard0, pm_valid=shard0, pm_q0=shard0, pm_t0=shard0,
        pm_params0=shard0, cm_src=shard0)
    out_specs = bw.WindowResult(cam_q=repl, cam_t=repl, pts=shard0,
                                pm_inlier=shard0, cost=repl)

    iu = jnp.asarray(
        [[0, 1, 2, 3, 4, 5], [1, 6, 7, 8, 9, 10], [2, 7, 11, 12, 13, 14],
         [3, 8, 12, 15, 16, 17], [4, 9, 13, 16, 18, 19],
         [5, 10, 14, 17, 19, 20]], jnp.int32)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(in_specs,),
                       out_specs=out_specs, check_vma=False)
    def _run(lp: PsumShardProblem):
        f = lambda a: a.reshape(-1)
        consts = bw._EdgeConsts(
            uvx=f(lp.pm_uv[..., 0]), uvy=f(lp.pm_uv[..., 1]),
            w0=f(lp.pm_w), valid=f(lp.pm_valid),
            is_free=f(lp.pm_cslot >= 0),
            cslot=f(jnp.clip(lp.pm_cslot, 0)),
            q0=tuple(f(lp.pm_q0[..., i]) for i in range(4)),
            t0=tuple(f(lp.pm_t0[..., i]) for i in range(3)),
            par=tuple(f(lp.pm_params0[..., i]) for i in range(8)))
        src_ok = lp.cm_src >= 0
        src = jnp.clip(lp.cm_src, 0)

        def cm_sum(V):
            """Per-camera sum of per-edge rows: gather [Kc, F_l, C] from
            the local [E_l, C] edge values, mask, reduce over F_l."""
            g = V[src] * src_ok[..., None].astype(V.dtype)
            return jnp.sum(g, axis=1)                       # [Kc, C]

        def msum(a):
            return jnp.sum(a.reshape(Pl, M), axis=1)

        def damp(H, free, dim, lam):
            diag = jnp.diagonal(H, axis1=-2, axis2=-1)
            add = lam * jnp.maximum(diag, 1e-6) + 1e-8
            H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
            return jnp.where(free[:, None, None], H,
                             jnp.eye(dim, dtype=H.dtype))

        def lm_iter(cam_q, cam_t, pts_local, lam):
            c = consts
            rx, ry, jp, jc, dok = bw._soa_linearize(
                c, kind, cam_q, cam_t, pts_local, Pl, M)
            chi2 = c.w0 * (rx * rx + ry * ry)
            active = c.valid & dok
            cost_part = jnp.sum(jnp.where(
                active, bw._rho(chi2, huber_delta2), 0.0))
            w_rob = bw._huber_w(chi2, huber_delta2) if robust \
                else jnp.ones_like(chi2)
            w = jnp.where(active, c.w0 * w_rob, 0.0)

            # --- local point elimination
            wrx, wry = w * rx, w * ry
            g_p = jnp.stack([msum(jp[0] * wrx + jp[3] * wry),
                             msum(jp[1] * wrx + jp[4] * wry),
                             msum(jp[2] * wrx + jp[5] * wry)], axis=-1)
            hpp = [[None] * 3 for _ in range(3)]
            for a in range(3):
                for b in range(a, 3):
                    hpp[a][b] = msum(w * (jp[a] * jp[b]
                                          + jp[3 + a] * jp[3 + b]))
            Hpp = jnp.stack(
                [jnp.stack([hpp[0][0], hpp[0][1], hpp[0][2]], -1),
                 jnp.stack([hpp[0][1], hpp[1][1], hpp[1][2]], -1),
                 jnp.stack([hpp[0][2], hpp[1][2], hpp[2][2]], -1)], -2)
            Hpp_inv = bw._spd_inv3(damp(Hpp, lp.pt_valid, 3, lam))

            # --- per-edge camera-block values (flat SoA)
            cols = [jc[a] * wrx + jc[6 + a] * wry for a in range(6)]
            tri = [w * (jc[a] * jc[b] + jc[6 + a] * jc[6 + b])
                   for a in range(6) for b in range(a, 6)]
            wb = [w * (jc[a] * jp[b] + jc[6 + a] * jp[3 + b])
                  for a in range(6) for b in range(3)]        # 18 x [E_l]

            # per-edge A = Wblk L_p (L = chol(Hpp^-1), lower) -> Schur
            # diagonal D_e = A A^T (the block-Jacobi preconditioner term)
            L = bw._chol3(Hpp_inv)                            # [Pl, 3, 3]
            Le = [jnp.broadcast_to(L[:, a, b][:, None],
                                   (Pl, M)).reshape(-1)
                  for a in range(3) for b in range(3)]
            A = []
            for a in range(6):
                A.append(wb[a * 3 + 0] * Le[0] + wb[a * 3 + 1] * Le[3]
                         + wb[a * 3 + 2] * Le[6])             # col 0
                A.append(wb[a * 3 + 1] * Le[4] + wb[a * 3 + 2] * Le[7])
                A.append(wb[a * 3 + 2] * Le[8])
            dtri = [A[a * 3] * A[b * 3] + A[a * 3 + 1] * A[b * 3 + 1]
                    + A[a * 3 + 2] * A[b * 3 + 2]
                    for a in range(6) for b in range(a, 6)]   # 21 x [E_l]

            # per-edge W z0 (the Schur RHS half)
            z0 = jnp.einsum("pab,pb->pa", Hpp_inv, g_p)       # [Pl, 3]
            z0e = [jnp.broadcast_to(z0[:, b][:, None],
                                    (Pl, M)).reshape(-1) for b in range(3)]
            bz = [wb[a * 3 + 0] * z0e[0] + wb[a * 3 + 1] * z0e[1]
                  + wb[a * 3 + 2] * z0e[2] for a in range(6)]

            # --- ONE packed assembly psum: [Kc, 54] + cost
            V = jnp.stack(cols + tri + dtri + bz, axis=-1)    # [E_l, 54]
            part = cm_sum(V)                                  # [Kc, 54]
            flat = jnp.concatenate([part.reshape(-1), cost_part[None]])
            flat = jax.lax.psum(flat, axis)
            red = flat[:-1].reshape(Kc, 54)
            cost_here = flat[-1]
            g_c = red[:, :6]
            Hcc_l = damp(red[:, 6:27][:, iu], lp.cam_valid, 6, lam)
            D = red[:, 27:48][:, iu]
            b = -g_c + red[:, 48:54]
            b = jnp.where(lp.cam_valid[:, None], b, 0.0)
            M_inv = bw._spd_inv6(Hcc_l - D)

            Wstack = jnp.stack(wb, axis=-1)                   # [E_l, 18]

            def S_mv(v):
                """(Hcc_l - W Hpp^-1 W^T) v with ONE [Kc, 6] psum."""
                vc = jnp.stack([v[:, a][consts.cslot]
                                for a in range(6)], -1)       # [E_l, 6]
                u_e = jnp.einsum("eab,ea->eb",
                                 Wstack.reshape(E_l, 6, 3), vc)
                u = jnp.stack([msum(u_e[:, b0]) for b0 in range(3)], -1)
                z = jnp.einsum("pab,pb->pa", Hpp_inv, u)      # [Pl, 3]
                ze = jnp.broadcast_to(z[:, None, :],
                                      (Pl, M, 3)).reshape(E_l, 3)
                back_e = jnp.einsum("eab,eb->ea",
                                    Wstack.reshape(E_l, 6, 3), ze)
                back = jax.lax.psum(cm_sum(back_e), axis)     # [Kc, 6]
                Sv = jnp.einsum("kab,kb->ka", Hcc_l, v) - back
                return jnp.where(lp.cam_valid[:, None], Sv, v)

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
                den = jnp.sum(p * Sp)
                alpha = rz / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
                x = x + alpha * p
                rr = rr - alpha * Sp
                zz = precond(rr)
                rz_new = jnp.sum(rr * zz)
                beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
                return x, rr, zz + beta * p, rz_new

            x, rr, p, rz = jax.lax.fori_loop(0, cg_iters, cg_body,
                                             (x, rr, p, rz))
            dx_c = jnp.where(lp.cam_valid[:, None], x, 0.0)

            # local point back-substitution
            vc = jnp.stack([dx_c[:, a][consts.cslot]
                            for a in range(6)], -1)
            u_e = jnp.einsum("eab,ea->eb", Wstack.reshape(E_l, 6, 3), vc)
            u = jnp.stack([msum(u_e[:, b0]) for b0 in range(3)], -1)
            dx_p = jnp.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
            dx_p = jnp.where(lp.pt_valid[:, None], dx_p, 0.0)
            dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)

            dT = lie.se3_exp(dx_c)
            nq = lie.quat_normalize(lie.quat_mul(dT.q, cam_q))
            nt = lie.quat_rotate(dT.q, cam_t) + dT.t
            return nq, nt, pts_local + dx_p, cost_here

        def body(_, carry):
            bq, bt, bp, bcost, q, t, p, lam = carry
            nq, nt, np_, cost = lm_iter(q, t, p, lam)
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
        q0, t0, p0 = lp.cam_q, lp.cam_t, lp.pts
        bq, bt, bp, bcost, _, _, _, _ = jax.lax.fori_loop(
            0, iters + 1, body,
            (q0, t0, p0, big, q0, t0, p0, jnp.asarray(1e-4, jnp.float32)))

        # final chi2 inlier classification (local, no collective)
        rx, ry, _, _, dok = bw._soa_linearize(consts, kind, bq, bt, bp,
                                              Pl, M)
        chi2 = consts.w0 * (rx * rx + ry * ry)
        inlier = (consts.valid & dok & (chi2 < chi2_th)).reshape(Pl, M)
        return bw.WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                               pm_inlier=inlier, cost=bcost)

    return jax.jit(_run)


@functools.lru_cache(maxsize=None)
def _make_dense_runner(mesh: Mesh, kind: int, axis: str, iters: int,
                       huber_delta2: float, robust: bool, chi2_th: float,
                       Kc: int, Pw: int, M: int):
    n = mesh.shape[axis]
    Pl = Pw // n

    shard0 = P(axis)
    repl = P()
    # camera block replicated; point block + pm edges owner-partitioned;
    # the camera-major view is unused by the dense path (spec'd sharded so
    # with_cm=False zero-row problems and full problems both slice)
    in_specs = bw.WindowProblem(
        cam_idx=repl, cam_valid=repl, cam_q=repl, cam_t=repl,
        cam_params=repl,
        cm_uv=shard0, cm_w=shard0, cm_pt=shard0, cm_mslot=shard0,
        cm_valid=shard0,
        pt_idx=shard0, pt_valid=shard0, pts=shard0,
        pm_kf=shard0, pm_feat=shard0, pm_cslot=shard0,
        pm_uv=shard0, pm_w=shard0, pm_valid=shard0,
        pm_q0=shard0, pm_t0=shard0, pm_params0=shard0,
        cam_slot_of=repl, pt_slot_of=repl)
    out_specs = bw.WindowResult(cam_q=repl, cam_t=repl, pts=shard0,
                                pm_inlier=shard0, cost=repl)

    iu = jnp.asarray(
        [[0, 1, 2, 3, 4, 5], [1, 6, 7, 8, 9, 10], [2, 7, 11, 12, 13, 14],
         [3, 8, 12, 15, 16, 17], [4, 9, 13, 16, 18, 19],
         [5, 10, 14, 17, 19, 20]], jnp.int32)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(in_specs,),
                       out_specs=out_specs, check_vma=False)
    def _run(lp: bw.WindowProblem):
        consts = bw._flatten_consts(lp)            # local [E_l] SoA
        mask_flat = consts.valid

        def damp(H, free, dim, lam):
            diag = jnp.diagonal(H, axis1=-2, axis2=-1)
            add = lam * jnp.maximum(diag, 1e-6) + 1e-8
            H = H + add[..., None] * jnp.eye(dim, dtype=H.dtype)
            return jnp.where(free[:, None, None], H,
                             jnp.eye(dim, dtype=H.dtype))

        def msum(a):
            return jnp.sum(a.reshape(Pl, M), axis=1)

        def lm_iter(cam_q, cam_t, pts_local, lam):
            c = consts
            rx, ry, jp, jc, dok = bw._soa_linearize(
                c, kind, cam_q, cam_t, pts_local, Pl, M)
            chi2 = c.w0 * (rx * rx + ry * ry)
            active = mask_flat & dok
            cost_part = jnp.sum(jnp.where(
                active, bw._rho(chi2, huber_delta2), 0.0))
            w_rob = bw._huber_w(chi2, huber_delta2) if robust \
                else jnp.ones_like(chi2)
            w = jnp.where(active, c.w0 * w_rob, 0.0)

            # local point elimination (each point owned by one device)
            wrx, wry = w * rx, w * ry
            g_p = jnp.stack([msum(jp[0] * wrx + jp[3] * wry),
                             msum(jp[1] * wrx + jp[4] * wry),
                             msum(jp[2] * wrx + jp[5] * wry)], axis=-1)
            hpp = [[None] * 3 for _ in range(3)]
            for a in range(3):
                for b in range(a, 3):
                    hpp[a][b] = msum(w * (jp[a] * jp[b]
                                          + jp[3 + a] * jp[3 + b]))
            Hpp = jnp.stack(
                [jnp.stack([hpp[0][0], hpp[0][1], hpp[0][2]], -1),
                 jnp.stack([hpp[0][1], hpp[1][1], hpp[1][2]], -1),
                 jnp.stack([hpp[0][2], hpp[1][2], hpp[2][2]], -1)], -2)
            Hpp_inv = bw._spd_inv3(damp(Hpp, lp.pt_valid, 3, lam))

            # local shard of the reduced camera system
            cols = [jc[a] * wrx + jc[6 + a] * wry for a in range(6)]
            tri = [w * (jc[a] * jc[b] + jc[6 + a] * jc[6 + b])
                   for a in range(6) for b in range(a, 6)]
            S_e = jnp.stack(cols + tri, axis=-1)           # [E_l, 27]
            O = ((c.cslot[:, None] == jnp.arange(Kc, dtype=jnp.int32))
                 & c.is_free[:, None]).astype(jnp.float32)  # [E_l, Kc]
            red_part = O.T @ S_e                           # [Kc, 27]

            wb = [w * (jc[a] * jp[b] + jc[6 + a] * jp[3 + b])
                  for a in range(6) for b in range(3)]
            Wstack = jnp.stack(wb, axis=-1)                # [E_l, 18]
            Z = jnp.einsum("pmk,pmj->pkj", O.reshape(Pl, M, Kc),
                           Wstack.reshape(Pl, M, 18)).reshape(Pl, Kc, 6, 3)

            L = bw._chol3(Hpp_inv)
            Zl = jnp.einsum("pkab,pbc->pkac", Z, L)
            Zf = Zl.transpose(0, 3, 1, 2).reshape(Pl * 3, Kc * 6)
            C_part = Zf.T @ Zf                             # [6Kc, 6Kc]
            z0 = jnp.einsum("pab,pb->pa", Hpp_inv, g_p)
            bz_part = jnp.einsum("pkab,pb->ka", Z, z0)     # [Kc, 6]

            # the iteration's ONLY collective: one fused psum
            flat = jnp.concatenate([
                C_part.reshape(-1), red_part.reshape(-1),
                bz_part.reshape(-1), cost_part[None]])
            flat = jax.lax.psum(flat, axis)
            o1 = Kc * 6 * Kc * 6
            C = flat[:o1].reshape(Kc * 6, Kc * 6)
            red = flat[o1:o1 + Kc * 27].reshape(Kc, 27)
            bz = flat[o1 + Kc * 27:o1 + Kc * 27 + Kc * 6].reshape(Kc, 6)
            cost_here = flat[-1]

            g_c = red[:, :6]
            Hcc_l = damp(red[:, 6:][:, iu], lp.cam_valid, 6, lam)
            ii = jnp.arange(Kc)
            H_red = (-C).reshape(Kc, 6, Kc, 6).at[ii, :, ii, :].add(
                Hcc_l, unique_indices=True).reshape(Kc * 6, Kc * 6)
            b = -g_c + bz
            chol = jax.scipy.linalg.cho_factor(H_red)
            dx = jax.scipy.linalg.cho_solve(
                chol, b.reshape(-1)).reshape(Kc, 6)
            dx_c = jnp.where(lp.cam_valid[:, None], dx, 0.0)
            dx_c = jnp.where(jnp.all(jnp.isfinite(dx_c)), dx_c, 0.0)

            # local point back-substitution
            vc = [dx_c[:, a][c.cslot] for a in range(6)]
            u = jnp.stack(
                [msum(sum(wb[a * 3 + b0] * vc[a] for a in range(6)))
                 for b0 in range(3)], axis=-1)
            dx_p = jnp.einsum("pab,pb->pa", Hpp_inv, -g_p - u)
            dx_p = jnp.where(lp.pt_valid[:, None], dx_p, 0.0)
            dx_p = jnp.where(jnp.isfinite(dx_p), dx_p, 0.0)

            dT = lie.se3_exp(dx_c)
            nq = lie.quat_normalize(lie.quat_mul(dT.q, cam_q))
            nt = lie.quat_rotate(dT.q, cam_t) + dT.t
            return nq, nt, pts_local + dx_p, cost_here

        def body(_, carry):
            bq, bt, bp, bcost, q, t, p, lam = carry
            nq, nt, np_, cost = lm_iter(q, t, p, lam)
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
        q0, t0, p0 = lp.cam_q, lp.cam_t, lp.pts
        bq, bt, bp, bcost, _, _, _, _ = jax.lax.fori_loop(
            0, iters + 1, body,
            (q0, t0, p0, big, q0, t0, p0, jnp.asarray(1e-4, jnp.float32)))

        # final chi2 inlier classification (local, no collective)
        rx, ry, _, _, dok = bw._soa_linearize(consts, kind, bq, bt, bp,
                                              Pl, M)
        chi2 = consts.w0 * (rx * rx + ry * ry)
        inlier = (consts.valid & dok
                  & (chi2 < chi2_th)).reshape(Pl, M)
        return bw.WindowResult(cam_q=bq, cam_t=bt, pts=bp,
                               pm_inlier=inlier, cost=bcost)

    return jax.jit(_run)


# ---------------------------------------------------------------------------
# production multi-chip GBA epoch
# ---------------------------------------------------------------------------

def dist_global_ba(ms, cfg, mesh: Mesh, map_id, kind: int,
                   axis: str = "shard", iters: int = 10,
                   dense_free_cap: int = 32):
    """Multi-chip full-map BA epoch over ``mesh`` — the distributed form
    of the server's synchronous GBA (``system._compiled.global_ba``;
    reference ``RunGlobalBundleAdjustment``
    /root/reference/src/LoopClosing.cc:3579 + src/Optimizer.cc:52).  Same
    anchor/mask/build/write-back as the single-chip epoch; the solve goes
    through ``dist_solve_window_ba`` (dense one-psum for small maps,
    psum-CG for large ones).  Enable from the server with
    ``ServerConfig.gba_mesh``.  Returns the updated MapState."""
    import jax.numpy as jnp

    from mam3slam_tpu.mapstate import state as S
    from mam3slam_tpu.slam import steps

    is2 = jnp.asarray(cfg.inv_sigma2)
    in_map = ms.kf_valid & (ms.kf_map == jnp.asarray(map_id))
    anchor1 = jnp.argmin(jnp.where(in_map, ms.kf_seq, S.BIG_SEQ))
    opt_mask = in_map.at[anchor1].set(False)
    prob = steps.build_window_problem(ms, opt_mask, is2, cfg.max_kf,
                                      cfg.max_mp, with_cm=False)
    res = dist_solve_window_ba(prob, mesh, kind, axis=axis, iters=iters,
                               dense_free_cap=dense_free_cap)
    return steps.apply_window_result(ms, prob, res)

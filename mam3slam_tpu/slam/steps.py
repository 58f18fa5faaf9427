"""Jitted per-frame SLAM steps: local-map tracking, triangulation, fuse, BA.

These are the device-side building blocks of the Tracking / LocalMapping
threads of the reference (SURVEY.md §2.2, call stacks §3.2-3.3), re-expressed
as pure fixed-shape functions over the SoA ``MapState``:

* ``project_into_frame``      — MapPoint::isInFrustum + PredictScale batched
  over the whole point arena (reference Tracking::SearchLocalPoints loop).
* ``match_map_to_frame``      — ORBmatcher::SearchByProjection(Frame, vMPs)
  as one dense masked Hamming problem.
* ``track_pose``              — Optimizer::PoseOptimization on the matches.
* ``triangulate_with_neighbor``— LocalMapping::CreateNewMapPoints for one
  (new KF, neighbor KF) pair: epipolar-constrained matching of un-matched
  features, DLT triangulation, parallax/depth/reprojection/scale gates.
* ``fuse_into_kf``            — ORBmatcher::Fuse projection fusion.
* ``build_local_ba_problem`` / ``apply_ba_result`` — windowed LBA wiring.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie
from mam3slam_tpu.mapstate import state as S
from mam3slam_tpu.ops import matching as M
from mam3slam_tpu.solvers import ba as ba_mod
from mam3slam_tpu.solvers import twoview


class FrameObs(NamedTuple):
    """Per-frame feature data in match space (undistorted)."""

    uv: jnp.ndarray      # [F, 2]
    level: jnp.ndarray   # [F] i32
    angle: jnp.ndarray   # [F] f32
    desc: jnp.ndarray    # [F, 32] u8
    valid: jnp.ndarray   # [F] bool


# ---------------------------------------------------------------------------
# frustum / scale prediction
# ---------------------------------------------------------------------------

def project_into_frame(ms: S.MapState, q, t, cam: cam_mod.Camera,
                       width: float, height: float, mp_mask,
                       scale_factors, view_cos_limit: float = 0.5):
    """Batched isInFrustum: project every masked map point into the frame.

    Returns (uv [P, 2], pred_level [P], visible [P], dist [P]).
    """
    Xc = lie.quat_rotate(q[None, :], ms.mp_pos) + t[None, :]
    uv = cam_mod.project_ideal(cam, Xc)
    depth_ok = Xc[:, 2] > 0.05
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < height))
    C = -lie.quat_rotate(lie.quat_conj(q), t)  # camera center (world)
    vec = ms.mp_pos - C[None, :]
    dist = jnp.linalg.norm(vec, axis=-1)
    dist_ok = (dist >= 0.8 * ms.mp_min_dist) & (dist <= 1.2 * ms.mp_max_dist)
    view_cos = jnp.sum(vec * ms.mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
    angle_ok = view_cos > view_cos_limit
    # PredictScale: level = ceil(log(max_dist / dist) / log(scale))
    n_levels = scale_factors.shape[0]
    ratio = ms.mp_max_dist / jnp.maximum(dist, 1e-9)
    level = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9))
                     / jnp.log(scale_factors[1])).astype(jnp.int32)
    level = jnp.clip(level, 0, n_levels - 1)
    visible = mp_mask & ms.mp_valid & depth_ok & in_img & dist_ok & angle_ok
    return uv, level, visible, view_cos


def match_map_to_frame(ms: S.MapState, frame: FrameObs, q, t,
                       cam: cam_mod.Camera, width, height, mp_mask,
                       scale_factors, th_radius: float = 1.0,
                       max_dist: int = M.TH_HIGH, ratio: float = 0.8,
                       cap: int = 4096):
    """SearchByProjection of (masked) map points into a frame.

    The frustum-visible candidates are compacted to a static ``cap``
    before the dense Hamming problem, so per-frame matching cost is
    independent of the total arena size (the reference likewise bounds the
    local map; overflow beyond `cap` visible points is dropped arbitrarily,
    matching its 80-KF local-map cap in spirit).

    Returns (feat_mp [F] i32 assignment, n_matches, visible_mask [P]).
    """
    uv_p, lvl_p, visible, view_cos = project_into_frame(
        ms, q, t, cam, width, height, mp_mask, scale_factors)
    # reference radius: 2.5 px if viewing angle close, else 4.0, x scale
    base_r = jnp.where(view_cos > 0.998, 2.5, 4.0)
    radius = th_radius * base_r * scale_factors[lvl_p]

    P = ms.mp_pos.shape[0]
    cap = min(cap, P)
    # compact visible candidates to the front (stable by slot id) via
    # cumsum + scatter — ~4x cheaper than an argsort over the arena
    pos = jnp.cumsum(visible.astype(jnp.int32)) - 1
    ok = visible & (pos < cap)
    tgt = jnp.where(ok, pos, cap)  # out-of-range rows drop
    sel = jnp.zeros(cap, jnp.int32).at[tgt].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    sel_vis = jnp.zeros(cap, bool).at[tgt].set(True, mode="drop")
    bits_mp = M.unpack_desc(ms.mp_desc[sel])
    bits_f = M.unpack_desc(frame.desc)
    res = M.search_by_projection_frame(
        uv_p[sel], lvl_p[sel], radius[sel], bits_mp, sel_vis,
        frame.uv, frame.level, bits_f, frame.valid,
        max_dist=max_dist, ratio=ratio)
    # invert: per-feature map point (in original arena indices)
    F = frame.uv.shape[0]
    feat_mp = jnp.full((F,), S.NO_MP, jnp.int32)
    feat_mp = feat_mp.at[jnp.where(res.ok, res.idx, F - 1)].set(
        jnp.where(res.ok, sel, feat_mp[jnp.where(res.ok, res.idx, F - 1)]))
    n = jnp.sum(res.ok.astype(jnp.int32))
    return feat_mp, n, visible


def track_pose(ms: S.MapState, frame: FrameObs, feat_mp, q0, t0,
               cam: cam_mod.Camera, inv_sigma2):
    """PoseOptimization over the current frame<->map matches.

    Returns (q, t, feat_inlier [F] bool, n_inliers).
    """
    has = feat_mp >= 0
    mp = jnp.clip(feat_mp, 0)
    pts = ms.mp_pos[mp]
    w = inv_sigma2[frame.level]
    res = ba_mod.pose_optimization(
        q0, t0, cam.params, cam.kind, pts, frame.uv, w,
        has & frame.valid & ms.mp_valid[mp])
    return res.q, res.t, res.inlier, res.n_inliers


# ---------------------------------------------------------------------------
# triangulation (LocalMapping::CreateNewMapPoints, one neighbor pair)
# ---------------------------------------------------------------------------

def _mm(a, b):
    """Full-float32 matmul: the epipolar search and the DLT gates compare
    pixel residuals against chi2 thresholds, and a TF32 product (about
    three decimal digits) moves them across."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _fundamental_from_poses(q1, t1, q2, t2, K1, K2):
    """F12 with x2^T F12 x1 = 0 for cams (T_cw1) and (T_cw2)."""
    R1 = lie.quat_to_matrix(q1)
    R2 = lie.quat_to_matrix(q2)
    R12 = _mm(R2, R1.T)                   # cam1 -> cam2
    t12 = t2 - _mm(R12, t1)
    E = _mm(lie.hat(t12), R12)            # x2c^T E x1c = 0
    return _mm(_mm(jnp.linalg.inv(K2).T, E), jnp.linalg.inv(K1))


def triangulate_with_neighbor(ms: S.MapState, kf1, kf2,
                              kind: int, sigma2_per_level,
                              min_parallax_cos: float = 0.9998):
    """Match un-associated features of kf1 against kf2 along the epipolar
    line, triangulate, and gate (depth, parallax, chi2 reprojection in both
    views, scale consistency).  Returns a candidate batch:
    (ok [F], pos [F, 3], feat1 [F], feat2 [F]).
    """
    F = ms.kf_feat_uv.shape[1]
    uv1 = ms.kf_feat_uv[kf1]
    uv2 = ms.kf_feat_uv[kf2]
    free1 = ms.kf_feat_valid[kf1] & (ms.kf_feat_mp[kf1] < 0)
    free2 = ms.kf_feat_valid[kf2] & (ms.kf_feat_mp[kf2] < 0)
    q1, t1 = ms.kf_q[kf1], ms.kf_t[kf1]
    q2, t2 = ms.kf_q[kf2], ms.kf_t[kf2]
    cam1 = cam_mod.Camera(ms.kf_cam[kf1], kind)
    cam2 = cam_mod.Camera(ms.kf_cam[kf2], kind)
    if kind == cam_mod.KANNALA_BRANDT8:
        # epipolar-line search + DLT are pinhole geometry: lift the raw
        # fisheye keypoints to ideal-pinhole coords (the reference's
        # SearchForTriangulation/Triangulate for KB8 unprojects first);
        # the chi2 reprojection gates below stay in the RAW match space
        # via project_ideal (= full KB8 model)
        uv1_g = cam_mod.undistort_points(cam1, uv1)
        uv2_g = cam_mod.undistort_points(cam2, uv2)
    else:
        uv1_g, uv2_g = uv1, uv2
    K1, K2 = cam1.K(), cam2.K()
    F12 = _fundamental_from_poses(q1, t1, q2, t2, K1, K2)

    bits1 = M.unpack_desc(ms.kf_feat_desc[kf1])
    bits2 = M.unpack_desc(ms.kf_feat_desc[kf2])
    res = M.search_for_triangulation(
        uv1_g, bits1, ms.kf_feat_level[kf1], free1,
        uv2_g, bits2, ms.kf_feat_level[kf2], free2,
        F12, sigma2_per_level)

    idx2 = jnp.clip(res.idx, 0)
    R1 = lie.quat_to_matrix(q1)
    R2 = lie.quat_to_matrix(q2)
    P1 = _mm(K1, jnp.concatenate([R1, t1[:, None]], axis=1))
    P2 = _mm(K2, jnp.concatenate([R2, t2[:, None]], axis=1))
    X = twoview.triangulate_dlt(
        jnp.broadcast_to(P1, (F, 3, 4)), jnp.broadcast_to(P2, (F, 3, 4)),
        uv1_g, uv2_g[idx2])

    # gates (reference CreateNewMapPoints :504-828)
    C1 = -_mm(R1.T, t1)
    C2 = -_mm(R2.T, t2)
    r1 = X - C1
    r2 = X - C2
    d1 = jnp.linalg.norm(r1, axis=-1)
    d2 = jnp.linalg.norm(r2, axis=-1)
    cos_par = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(d1 * d2, 1e-9)

    Xc1 = _mm(X, R1.T) + t1
    Xc2 = _mm(X, R2.T) + t2
    z_ok = (Xc1[:, 2] > 1e-3) & (Xc2[:, 2] > 1e-3)

    pr1 = cam_mod.project_ideal(cam1, Xc1)
    pr2 = cam_mod.project_ideal(cam2, Xc2)
    s1 = sigma2_per_level[ms.kf_feat_level[kf1]]
    s2 = sigma2_per_level[ms.kf_feat_level[kf2][idx2]]
    e1 = jnp.sum((pr1 - uv1) ** 2, axis=-1)
    e2 = jnp.sum((pr2 - uv2[idx2]) ** 2, axis=-1)
    reproj_ok = (e1 < 5.991 * s1) & (e2 < 5.991 * s2)

    # scale consistency: ratio of distances vs ratio of octave scales
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    sf = jnp.sqrt(sigma2_per_level[1])  # per-level factor
    ratio_octave = (jnp.sqrt(sigma2_per_level)[ms.kf_feat_level[kf1]]
                    / jnp.sqrt(sigma2_per_level)[
                        ms.kf_feat_level[kf2][idx2]])
    scale_ok = ((ratio_dist * 1.5 * sf > ratio_octave)
                & (ratio_dist < ratio_octave * 1.5 * sf))

    finite = jnp.all(jnp.isfinite(X), axis=-1)
    ok = (res.ok & z_ok & reproj_ok & scale_ok & finite
          & (cos_par < min_parallax_cos) & (cos_par > 0.0))
    return ok, jnp.where(finite[:, None], X, 0.0), \
        jnp.arange(F, dtype=jnp.int32), idx2


def add_triangulated_points(ms: S.MapState, kf1, kf2, ok, X, feat1, feat2,
                            map_id):
    """Allocate slots for a triangulated batch and wire observations in
    both keyframes.  ``kf2`` may be a scalar or a per-point [F] array (the
    batched multi-neighbor path).  Returns (ms, n_dropped) — requests
    beyond the arena's free capacity are dropped (defined overflow
    behavior)."""
    slots, granted = S.alloc_mp_slots(ms, ok)
    n_dropped = jnp.sum((ok & ~granted).astype(jnp.int32))
    ok = granted
    P = ms.mp_valid.shape[0]
    w = jnp.where(ok, slots, P - 1)
    ms = ms._replace(
        mp_pos=ms.mp_pos.at[w].set(jnp.where(ok[:, None], X, ms.mp_pos[w])),
        mp_valid=ms.mp_valid.at[w].set(
            jnp.where(ok, True, ms.mp_valid[w])),
        mp_map=ms.mp_map.at[w].set(jnp.where(ok, map_id, ms.mp_map[w])),
        mp_first_kf=ms.mp_first_kf.at[w].set(
            jnp.where(ok, ms.kf_seq[kf1], ms.mp_first_kf[w])),
        mp_first_agent=ms.mp_first_agent.at[w].set(
            jnp.where(ok, ms.kf_agent[kf1], ms.mp_first_agent[w])),
        mp_first_agent_kf=ms.mp_first_agent_kf.at[w].set(
            jnp.where(ok, ms.kf_agent_kf_id[kf1],
                      ms.mp_first_agent_kf[w])),
        mp_ref_kf=ms.mp_ref_kf.at[w].set(
            jnp.where(ok, kf1, ms.mp_ref_kf[w])),
        mp_found=ms.mp_found.at[w].set(jnp.where(ok, 1.0, ms.mp_found[w])),
        mp_visible=ms.mp_visible.at[w].set(
            jnp.where(ok, 1.0, ms.mp_visible[w])),
        mp_nobs=ms.mp_nobs.at[w].set(jnp.where(ok, 0, ms.mp_nobs[w])),
    )
    F = feat1.shape[0]
    ms = S.mp_add_observation(ms, slots, jnp.full((F,), kf1, jnp.int32),
                              feat1, ok)
    kf2_arr = jnp.broadcast_to(jnp.asarray(kf2, jnp.int32), (F,))
    ms = S.mp_add_observation(ms, slots, kf2_arr, feat2, ok)
    return ms, n_dropped


# ---------------------------------------------------------------------------
# fuse (ORBmatcher::Fuse)
# ---------------------------------------------------------------------------

def fuse_into_kf(ms: S.MapState, kf, mp_mask, kind: int,
                 width, height, scale_factors, max_dist: int = M.TH_LOW):
    """Project masked map points into keyframe `kf`; where the best match
    feature already has a point, mark (src=new, dst=existing) replacement
    pairs; where free, add the observation.

    Returns (ms, n_fused).  Reference keeps the point with more
    observations; we keep the existing (older) point — both resolve the
    duplicate; observation counts then concentrate on the survivor.
    """
    frame = FrameObs(uv=ms.kf_feat_uv[kf], level=ms.kf_feat_level[kf],
                     angle=ms.kf_feat_angle[kf], desc=ms.kf_feat_desc[kf],
                     valid=ms.kf_feat_valid[kf])
    cam = cam_mod.Camera(ms.kf_cam[kf], kind)
    q, t = ms.kf_q[kf], ms.kf_t[kf]
    uv_p, lvl_p, visible, _ = project_into_frame(
        ms, q, t, cam, width, height, mp_mask, scale_factors)
    radius = 3.0 * scale_factors[lvl_p]
    res = M.search_by_projection_frame(
        uv_p, lvl_p, radius, M.unpack_desc(ms.mp_desc), visible,
        frame.uv, frame.level, M.unpack_desc(frame.desc), frame.valid,
        max_dist=max_dist)
    # don't fuse a point into its own observation slot
    cur_mp_at_feat = ms.kf_feat_mp[kf][jnp.clip(res.idx, 0)]
    P = ms.mp_pos.shape[0]
    self_match = cur_mp_at_feat == jnp.arange(P)
    ok = res.ok & ~self_match

    occupied = cur_mp_at_feat >= 0
    # case 1: feature already has a point -> replace src(=this mp) by dst
    rep_ok = ok & occupied & ms.mp_valid[jnp.clip(cur_mp_at_feat, 0)]
    ms = S.replace_map_points(ms, jnp.arange(P, dtype=jnp.int32),
                              jnp.clip(cur_mp_at_feat, 0), rep_ok)
    # case 2: free feature -> new observation
    add_ok = ok & ~occupied
    ms = S.mp_add_observation(
        ms, jnp.arange(P, dtype=jnp.int32),
        jnp.full((P,), kf, jnp.int32), jnp.clip(res.idx, 0), add_ok)
    # points whose observation sets changed (survivor of a replace, or a
    # new observation) — the compact-stat-refresh set
    touched = add_ok | jnp.zeros((P,), bool).at[
        jnp.where(rep_ok, jnp.clip(cur_mp_at_feat, 0), P - 1)].max(rep_ok)
    return ms, jnp.sum(ok.astype(jnp.int32)), touched


# ---------------------------------------------------------------------------
# local BA wiring
# ---------------------------------------------------------------------------

def keyframe_redundancy(ms: S.MapState, kf, scale_margin: int = 1):
    """Fraction of kf's tracked map points seen by >= 3 OTHER keyframes at
    the same or finer scale (reference LocalMapping::KeyFrameCulling
    :1018-1116: cull when >= 90%).

    Returns (redundant_frac, n_tracked).
    """
    F = ms.kf_feat_mp.shape[1]
    Mo = ms.mp_obs_kf.shape[1]
    mp = ms.kf_feat_mp[kf]
    has = (mp >= 0) & ms.kf_feat_valid[kf] & ms.mp_valid[jnp.clip(mp, 0)]
    mp_c = jnp.clip(mp, 0)
    my_level = ms.kf_feat_level[kf]                        # [F]
    obs_kf = ms.mp_obs_kf[mp_c]                            # [F, M]
    obs_feat = ms.mp_obs_feat[mp_c]                        # [F, M]
    obs_ok = ((jnp.arange(Mo)[None, :] < ms.mp_nobs[mp_c][:, None])
              & (obs_kf >= 0) & (obs_kf != kf))
    obs_ok = obs_ok & ms.kf_valid[jnp.clip(obs_kf, 0)]
    other_level = ms.kf_feat_level[jnp.clip(obs_kf, 0),
                                   jnp.clip(obs_feat, 0)]  # [F, M]
    finer = obs_ok & (other_level <= my_level[:, None] + scale_margin)
    n_other = jnp.sum(finer, axis=-1)                      # [F]
    redundant = has & (n_other >= 3)
    n_tracked = jnp.sum(has.astype(jnp.int32))
    frac = jnp.sum(redundant.astype(jnp.float32)) / jnp.maximum(
        n_tracked.astype(jnp.float32), 1.0)
    return frac, n_tracked


def build_local_ba_problem(ms: S.MapState, opt_kf_mask,
                           inv_sigma2):
    """Assemble a BAProblem over the full arenas with masks:
    cameras in ``opt_kf_mask`` free, all other observing KFs fixed;
    points observed by the window free.

    Edge list = every (kf, feat) with an mp link where kf participates.
    Shapes stay static ([K*F] edges) — masks do the selection.
    """
    K, F = ms.kf_feat_mp.shape
    fmp = ms.kf_feat_mp
    pt_free = jnp.zeros((ms.mp_valid.shape[0],), bool).at[
        jnp.clip(fmp, 0).reshape(-1)].max(
        ((fmp >= 0) & opt_kf_mask[:, None]).reshape(-1))
    pt_free = pt_free & ms.mp_valid

    obs_kf_idx = jnp.repeat(jnp.arange(K, dtype=jnp.int32), F)
    obs_feat = jnp.tile(jnp.arange(F, dtype=jnp.int32), K)
    obs_mp = fmp.reshape(-1)
    edge_pt_free = pt_free[jnp.clip(obs_mp, 0)]
    obs_valid = ((obs_mp >= 0) & ms.kf_valid[obs_kf_idx]
                 & ms.mp_valid[jnp.clip(obs_mp, 0)]
                 & (opt_kf_mask[obs_kf_idx] | edge_pt_free))
    uv = ms.kf_feat_uv.reshape(-1, 2)
    w = inv_sigma2[ms.kf_feat_level.reshape(-1)]

    cam_free = opt_kf_mask & ms.kf_valid
    # fixed anchors: any valid KF observing a free point but not in window
    obs = ba_mod.Obs(cam=obs_kf_idx, pt=jnp.clip(obs_mp, 0), uv=uv, w=w,
                     valid=obs_valid)
    prob = ba_mod.BAProblem(
        cam_q=ms.kf_q, cam_t=ms.kf_t,
        cam_params=ms.kf_cam,  # per-KF intrinsics (heterogeneous agents)
        pts=ms.mp_pos, obs=obs, cam_free=cam_free, pt_free=pt_free)
    return prob


def compact_ba_problem(prob: ba_mod.BAProblem, cap: int, extra=None):
    """Compact the [K*F] masked edge list to a static ``cap`` (cumsum +
    scatter).  A windowed LBA touches only (window + boundary) keyframes'
    edges, but the dense builder emits the whole arena — every CG
    Hessian-vector product then sweeps dead edges.  Compaction makes LBA
    cost scale with the WINDOW, not the arena (8x at max_kf=512,
    lba_window=16).  Overflow beyond cap drops edges (generous caps keep
    this theoretical)."""
    keep = prob.obs.valid
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep & (pos < cap), pos, cap)

    def put(src, fill=0):
        out_shape = (cap + 1,) + src.shape[1:]
        out = jnp.full(out_shape, fill, src.dtype).at[idx].set(src)
        return out[:cap]

    obs = ba_mod.Obs(cam=put(prob.obs.cam), pt=put(prob.obs.pt),
                     uv=put(prob.obs.uv), w=put(prob.obs.w),
                     valid=put(prob.obs.valid, fill=False))
    if extra is not None:
        return prob._replace(obs=obs), put(extra)
    return prob._replace(obs=obs)


def apply_ba_result(ms: S.MapState, res: ba_mod.BAResult, opt_kf_mask,
                    pt_free) -> S.MapState:
    return ms._replace(
        kf_q=jnp.where(opt_kf_mask[:, None], res.cam_q, ms.kf_q),
        kf_t=jnp.where(opt_kf_mask[:, None], res.cam_t, ms.kf_t),
        mp_pos=jnp.where(pt_free[:, None], res.pts, ms.mp_pos),
    )


# ---------------------------------------------------------------------------
# dense two-view (scatter-free) window BA wiring — solvers/ba_window.py
# ---------------------------------------------------------------------------

def build_window_problem(ms: S.MapState, opt_mask, inv_sigma2,
                         cam_cap: int, pt_cap: int, with_cm: bool = True):
    """Assemble a ``WindowProblem`` (solvers/ba_window.py): free cameras
    compacted to ``[cam_cap]``, window points to ``[pt_cap]``, edges laid
    out densely camera-major ``[Kc, F]`` AND point-major ``[Pw, M]`` from
    the reverse-observation table.  Deliberately SCATTER-FREE (duplicate-
    index scatters serialize or need atomics): compactions are stable
    argsorts, the cm<->pm edge bridge is a dense [Kc, F, M] compare at build, and
    write-back (apply_window_result) is pure gathers through the
    arena-sized slot maps.

    Free cameras beyond ``cam_cap`` and window points beyond ``pt_cap``
    degrade gracefully to fixed (they keep constraining the problem but
    are not optimized)."""
    from mam3slam_tpu.solvers import ba_window as bw

    K, F = ms.kf_feat_mp.shape
    P, Mo = ms.mp_obs_kf.shape
    fmp = ms.kf_feat_mp

    # --- free-camera compaction (cumsum + unique-index scatter: same
    # stable order as an argsort compaction at a fraction of the cost —
    # the pt-side argsort over the 24k arena was ~1/3 of the build)
    cam_free = opt_mask & ms.kf_valid
    cpos = jnp.cumsum(cam_free.astype(jnp.int32)) - 1
    cam_slot_of = jnp.where(cam_free & (cpos < cam_cap), cpos, -1)  # [K]
    ctgt = jnp.where(cam_slot_of >= 0, cam_slot_of, cam_cap)
    cam_idx = jnp.full((cam_cap,), -1, jnp.int32).at[ctgt].set(
        jnp.arange(K, dtype=jnp.int32), mode="drop")
    cam_valid = cam_idx >= 0
    ci = jnp.clip(cam_idx, 0)
    eff_free = cam_slot_of >= 0            # overflowed free cams => fixed

    # --- window points: observed by an effective-free KF.  Computed from
    # the reverse-observation table (gather + reduce over M — the forward
    # [K*F] scatter-max this replaces needs atomics).
    obs_ok = ((jnp.arange(Mo)[None, :] < ms.mp_nobs[:, None])
              & (ms.mp_obs_kf >= 0))
    pt_free = jnp.any(obs_ok & eff_free[jnp.clip(ms.mp_obs_kf, 0)],
                      axis=1) & ms.mp_valid
    ppos = jnp.cumsum(pt_free.astype(jnp.int32)) - 1
    pt_slot_of = jnp.where(pt_free & (ppos < pt_cap), ppos, -1)     # [P]
    ptgt = jnp.where(pt_slot_of >= 0, pt_slot_of, pt_cap)
    pt_idx = jnp.full((pt_cap,), -1, jnp.int32).at[ptgt].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    pt_valid = pt_idx >= 0
    pi = jnp.clip(pt_idx, 0)

    # --- point-major view from the reverse-observation table
    pm_kf = ms.mp_obs_kf[pi]                                # [Pw, M]
    pm_feat = ms.mp_obs_feat[pi]
    slot_ok = jnp.arange(Mo)[None, :] < ms.mp_nobs[pi][:, None]
    kfc = jnp.clip(pm_kf, 0)
    ftc = jnp.clip(pm_feat, 0)
    fwd_agree = ms.kf_feat_mp[kfc, ftc] == pt_idx[:, None]
    pm_valid = (pt_valid[:, None] & slot_ok & (pm_kf >= 0)
                & ms.kf_valid[kfc] & fwd_agree)
    pm_cslot = jnp.where(pm_valid, cam_slot_of[kfc], -1)
    pm_uv = ms.kf_feat_uv[kfc, ftc]
    pm_w = inv_sigma2[ms.kf_feat_level[kfc, ftc]]
    pm_q0 = ms.kf_q[kfc]
    pm_t0 = ms.kf_t[kfc]
    pm_params0 = ms.kf_cam[kfc]

    # --- camera-major view; validity + obs-slot bridge derived FROM the
    # pm view by a dense compare over M, so both views describe exactly
    # the same edge set and cm edges know their pm slot (gather bridge).
    # The dense reduced-camera solver (ba_window.run_window_ba_dense) is
    # pm-only — ``with_cm=False`` skips this block (the [Kc, F, M] bridge
    # compare is the build's most expensive op) and emits 0-row cm arrays.
    if with_cm:
        cm_fmp = fmp[ci]                                    # [Kc, F]
        cm_pt = jnp.where(cm_fmp >= 0, pt_slot_of[jnp.clip(cm_fmp, 0)], -1)
        cm_uv = ms.kf_feat_uv[ci]
        cm_w = inv_sigma2[ms.kf_feat_level[ci]]
        ptc = jnp.clip(cm_pt, 0)
        hit = (pm_valid[ptc]                                # [Kc, F, M]
               & (pm_kf[ptc] == cam_idx[:, None, None])
               & (pm_feat[ptc] == jnp.arange(F, dtype=jnp.int32)[None, :,
                                                                 None]))
        cm_mslot = jnp.argmax(hit, axis=-1).astype(jnp.int32)
        cm_valid = (jnp.any(hit, axis=-1) & (cm_pt >= 0)
                    & cam_valid[:, None])
    else:
        cm_uv = jnp.zeros((0, F, 2), jnp.float32)
        cm_w = jnp.zeros((0, F), jnp.float32)
        cm_pt = jnp.zeros((0, F), jnp.int32)
        cm_mslot = jnp.zeros((0, F), jnp.int32)
        cm_valid = jnp.zeros((0, F), bool)

    return bw.WindowProblem(
        cam_idx=cam_idx, cam_valid=cam_valid,
        cam_q=ms.kf_q[ci], cam_t=ms.kf_t[ci], cam_params=ms.kf_cam[ci],
        cm_uv=cm_uv, cm_w=cm_w, cm_pt=cm_pt, cm_mslot=cm_mslot,
        cm_valid=cm_valid,
        pt_idx=pt_idx, pt_valid=pt_valid, pts=ms.mp_pos[pi],
        pm_kf=pm_kf, pm_feat=pm_feat, pm_cslot=pm_cslot,
        pm_uv=pm_uv, pm_w=pm_w, pm_valid=pm_valid,
        pm_q0=pm_q0, pm_t0=pm_t0, pm_params0=pm_params0,
        cam_slot_of=cam_slot_of, pt_slot_of=pt_slot_of)


def repair_window_reverse_obs(ms: S.MapState, prob,
                              drop_pm: jnp.ndarray) -> S.MapState:
    """Targeted reverse-observation repair after an outlier drop: rewrite
    ONLY the window points' ``mp_obs_*`` rows (compacting out dropped +
    stale entries) instead of re-sorting the full [K, F] forward table
    (``rebuild_reverse_obs`` — 400k-element argsort per call).  The pm
    rows were gathered from these exact obs rows at build, so compaction
    is a per-row stable sort over M."""
    P, Mo = ms.mp_obs_kf.shape
    keep = prob.pm_valid & ~drop_pm                        # [Pw, M]
    order = jnp.argsort(~keep, axis=1, stable=True)        # keepers first
    kf_s = jnp.take_along_axis(prob.pm_kf, order, axis=1)
    ft_s = jnp.take_along_axis(prob.pm_feat, order, axis=1)
    n_keep = jnp.sum(keep, axis=1)                         # [Pw]
    live = jnp.arange(Mo)[None, :] < n_keep[:, None]
    new_kf = jnp.where(live, kf_s, S.NO_KF)
    new_ft = jnp.where(live, ft_s, -1)
    # scatter rows back (unique arena targets; padding rows -> scratch)
    row_ok = prob.pt_idx >= 0
    w = jnp.where(row_ok, prob.pt_idx, P)
    obs_kf = jnp.concatenate([ms.mp_obs_kf,
                              jnp.zeros((1, Mo), jnp.int32)], 0)
    obs_ft = jnp.concatenate([ms.mp_obs_feat,
                              jnp.zeros((1, Mo), jnp.int32)], 0)
    nobs = jnp.concatenate([ms.mp_nobs, jnp.zeros((1,), jnp.int32)], 0)
    obs_kf = obs_kf.at[w].set(jnp.where(row_ok[:, None], new_kf,
                                        obs_kf[w]))[:P]
    obs_ft = obs_ft.at[w].set(jnp.where(row_ok[:, None], new_ft,
                                        obs_ft[w]))[:P]
    nobs = nobs.at[w].set(jnp.where(row_ok, n_keep, nobs[w]))[:P]
    return ms._replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_ft,
                       mp_nobs=nobs)


def window_pt_mask(ms: S.MapState, prob) -> jnp.ndarray:
    """Arena-sized bool mask of the points the window problem optimizes
    (the reference's spLocalWindowMPs)."""
    return prob.pt_slot_of >= 0


def apply_window_result(ms: S.MapState, prob, res,
                        drop_pm=None) -> S.MapState:
    """Write optimized poses/points back to the arena (pure gathers
    through the slot maps); optionally drop the observations in
    ``drop_pm`` ([Pw, M] bool — outlier edges) from the forward table.
    Caller must rebuild_reverse_obs afterwards when dropping."""
    K, F = ms.kf_feat_mp.shape

    cs = prob.cam_slot_of                                  # [K]
    csl = jnp.clip(cs, 0)
    kf_q = jnp.where((cs >= 0)[:, None], res.cam_q[csl], ms.kf_q)
    kf_t = jnp.where((cs >= 0)[:, None], res.cam_t[csl], ms.kf_t)

    ps = prob.pt_slot_of                                   # [P]
    psl = jnp.clip(ps, 0)
    mp_pos = jnp.where((ps >= 0)[:, None], res.pts[psl], ms.mp_pos)

    ms = ms._replace(kf_q=kf_q, kf_t=kf_t, mp_pos=mp_pos)
    if drop_pm is not None:
        # one scatter with UNIQUE indices (inactive edges routed to a
        # private scratch slot each) — no atomics needed
        Pw, Mo = drop_pm.shape
        nflat = K * F
        eidx = jnp.arange(Pw * Mo, dtype=jnp.int32)
        flat_tgt = jnp.where(
            drop_pm.reshape(-1),
            (prob.pm_kf.reshape(-1) * F + jnp.clip(
                prob.pm_feat.reshape(-1), 0)),
            nflat + eidx)
        fpad = jnp.concatenate(
            [ms.kf_feat_mp.reshape(-1),
             jnp.zeros((Pw * Mo,), jnp.int32)])
        fmp = fpad.at[flat_tgt].set(S.NO_MP, unique_indices=True,
                                    indices_are_sorted=False)[
            :nflat].reshape(K, F)
        ms = ms._replace(kf_feat_mp=fmp)
    return ms

"""SLAM system orchestration: tracking state machine + local mapping.

Host-side equivalent of the reference's per-agent Tracking/LocalMapping
threads (SURVEY.md §2.2, §3.2-3.3) around the jitted steps in ``steps.py``.
The reference decouples the two with queues + mutexes; here each tracked
frame runs the tracking step, and keyframe insertion synchronously runs the
mapping step (triangulate / fuse / local BA / cull) — an epoched pipeline
over one functional ``MapState`` (SURVEY.md §2.6 table: queues -> epochs).
Multi-agent: every agent shares the same MapState arena; the centralized
server (place recognition / loop closing / merging) consumes keyframes from
all agents (slam/server.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie
from mam3slam_tpu.mapstate import state as S
from mam3slam_tpu.ops import matching as M
from mam3slam_tpu.slam import steps
from mam3slam_tpu.solvers import ba as ba_mod
from mam3slam_tpu.solvers import ba_window as bw
from mam3slam_tpu.solvers import twoview
from mam3slam_tpu.utils.timing import Timers

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


def _se3_compose_np(q1, t1, q2, t2):
    """numpy a*b SE3 compose (wxyz quats) for host-side trajectory fixups."""
    aw, ax, ay, az = q1
    bw, bx, by, bz = q2
    q = np.array([aw * bw - ax * bx - ay * by - az * bz,
                  aw * bx + ax * bw + ay * bz - az * by,
                  aw * by - ax * bz + ay * bw + az * bx,
                  aw * bz + ax * by - ay * bx + az * bw], np.float32)
    q /= max(np.linalg.norm(q), 1e-12)
    u = q1[1:]
    uv = np.cross(u, t2)
    t = t2 + 2.0 * (q1[0] * uv + np.cross(u, uv)) + t1
    return q, t.astype(np.float32)


def _quat_rotate_np(q, v):
    u = np.asarray(q[1:])
    uv = np.cross(u, v)
    return np.asarray(v + 2.0 * (q[0] * uv + np.cross(u, uv)), np.float32)


def _se3_inverse_np(q, t):
    qc = np.array([q[0], -q[1], -q[2], -q[3]], np.float32)
    return qc, -_quat_rotate_np(qc, t)


class MapCapacityError(RuntimeError):
    """Raised on keyframe-arena or atlas map-slot exhaustion (the silent
    jit-scatter drop would otherwise corrupt bookkeeping)."""


@dataclass(frozen=True)
class SlamConfig:
    width: int
    height: int
    cam_kind: int = cam_mod.PINHOLE
    n_levels: int = 8
    scale_factor: float = 1.2
    max_kf: int = 512
    max_mp: int = 24576
    n_feat: int = 768
    max_obs: int = 16
    # tracking thresholds (reference Tracking.cc)
    min_init_matches: int = 100
    motion_search_radius: float = 15.0
    min_motion_matches: int = 20
    min_track_inliers: int = 30
    min_track_inliers_lost: int = 10
    kf_max_interval: int = 20        # frames (c1a analog)
    kf_min_interval: int = 3
    kf_ref_ratio: float = 0.9
    recently_lost_frames: int = 60
    # mono-inertial initialization: contiguous tracked span buffered
    # before estimating gravity/scale/biases (reference InitializeIMU)
    imu_init_window_s: float = 2.0
    # mapping
    n_triangulate_neighbors: int = 8
    lba_window: int = 16
    lba_iters: int = 6
    lba_polish_iters: int = 2
    lba_cg_iters: int = 30
    # dense window-BA caps (solvers/ba_window.py): free cameras beyond
    # lba_cam_cap / window points beyond lba_pt_cap stay fixed
    lba_cam_cap: int = 24
    lba_pt_cap: int = 8192

    @property
    def scale_factors(self):
        return np.array([self.scale_factor ** i
                         for i in range(self.n_levels)], np.float32)

    @property
    def inv_sigma2(self):
        return (1.0 / self.scale_factors ** 2).astype(np.float32)

    @property
    def sigma2(self):
        return (self.scale_factors ** 2).astype(np.float32)

    def map_config(self) -> S.MapConfig:
        return S.MapConfig(max_kf=self.max_kf, max_mp=self.max_mp,
                           n_feat=self.n_feat, max_obs=self.max_obs,
                           n_levels=self.n_levels,
                           scale_factor=self.scale_factor)


# --------------------------------------------------------------------------
# jitted composite steps (module-level, cached by (config, camera) closure)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _compiled(cfg: SlamConfig, kind: int):
    """Build jitted step functions closed over static config."""
    sf = jnp.asarray(cfg.scale_factors)
    is2 = jnp.asarray(cfg.inv_sigma2)
    s2 = jnp.asarray(cfg.sigma2)
    W, H = float(cfg.width), float(cfg.height)

    @jax.jit
    def match_and_pose(ms, frame, q0, t0, cam_params, mp_mask, th_radius,
                       max_dist, ratio):
        cam = cam_mod.Camera(cam_params, kind)
        feat_mp, n, visible = steps.match_map_to_frame(
            ms, frame, q0, t0, cam, W, H, mp_mask, sf,
            th_radius=th_radius, max_dist=max_dist, ratio=ratio)
        q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp, q0, t0,
                                              cam, is2)
        return feat_mp, n, q, t, inlier, n_in, visible

    @functools.partial(jax.jit, static_argnames=("n_local",))
    def local_mp_mask(ms, ref_kf, n_local):
        """Union of map points observed by the top covis KFs of ref_kf
        plus ref_kf itself (Tracking::UpdateLocalMap approximation:
        covisibility neighborhood of the reference keyframe)."""
        idx, w, ok = S.best_covisible(ms, ref_kf, n_local)
        kf_sel = jnp.zeros((ms.kf_valid.shape[0],), bool).at[
            jnp.where(ok, idx, ref_kf)].set(True).at[ref_kf].set(True)
        fmp = ms.kf_feat_mp
        P = ms.mp_valid.shape[0]
        mask = jnp.zeros((P,), bool).at[
            jnp.clip(fmp, 0).reshape(-1)].max(
            ((fmp >= 0) & kf_sel[:, None]).reshape(-1))
        return mask & ms.mp_valid

    @jax.jit
    def track_frame_step(ms, frame, ref_kf, vel_q, vel_t, has_vel,
                         q_last, t_last, q_ext, t_ext, use_ext,
                         cam_params):
        """The whole per-frame tracking pipeline as ONE device program:
        constant-velocity (or externally supplied, e.g. IMU) pose
        prediction -> local-map mask -> coarse motion-model projection
        match + pose opt -> in-device widened retry (``lax.cond``,
        reference widens 2x on <20 matches) -> fine re-match + pose opt
        from the refined pose -> keep-best -> found/visible stat deltas
        -> velocity and ref-KF-relative pose for the trajectory writer.

        Besides the packed ``vec`` for the host, the step returns the
        next frame's chain state (pose + velocity, failure-healed to the
        prediction) as DEVICE arrays, so consecutive frames chain
        device-to-device with no host readback in between — the host
        state machine consumes ``vec`` lazily (SlamSystem.pipeline)."""
        cam = cam_mod.Camera(cam_params, kind)
        # prediction: external pose if use_ext, else constant velocity
        q_cv, t_cv = (lambda v: (v.q, v.t))(lie.se3_compose(
            lie.SE3(vel_q, vel_t), lie.SE3(q_last, t_last)))
        q_pred = jnp.where(use_ext, q_ext,
                           jnp.where(has_vel, q_cv, q_last))
        t_pred = jnp.where(use_ext, t_ext,
                           jnp.where(has_vel, t_cv, t_last))
        q_pred = lie.quat_normalize(q_pred)
        local_mask = local_mp_mask(ms, ref_kf, 32)

        def _stage(q0, t0, th, ratio):
            feat_mp, n, visible = steps.match_map_to_frame(
                ms, frame, q0, t0, cam, W, H, local_mask, sf,
                th_radius=th, max_dist=M.TH_HIGH, ratio=ratio)
            q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp,
                                                  q0, t0, cam, is2)
            return feat_mp, n, q, t, inlier, n_in, visible

        r1 = _stage(q_pred, t_pred, jnp.asarray(6.0), 0.9)
        widened = r1[5] < cfg.min_track_inliers_lost
        r1 = jax.lax.cond(
            widened,
            lambda _: _stage(q_pred, t_pred, jnp.asarray(12.0), 0.9),
            lambda _: r1, None)
        feat_mp, n_m, q, t, inlier, n_in, visible = r1
        # fine local-map stage from the refined pose; keep the better
        r2 = _stage(q, t, jnp.asarray(1.0), 0.8)
        take2 = r2[5] >= n_in
        sel = lambda x2, x1: jnp.where(take2, x2, x1)
        feat_mp = sel(r2[0], feat_mp)
        n_m = sel(r2[1], n_m)
        q = sel(r2[2], q)
        t = sel(r2[3], t)
        inlier = sel(r2[4], inlier)
        n_in = sel(r2[5], n_in)
        visible = sel(r2[6], visible)
        ms2 = update_found_visible(ms, feat_mp, inlier, visible)
        # velocity T_cur * T_last^-1 and pose relative to the ref KF
        vel = lie.se3_compose(lie.SE3(q, t),
                              lie.se3_inverse(lie.SE3(q_last, t_last)))
        ref = jnp.clip(ref_kf, 0)
        rel = lie.se3_compose(
            lie.SE3(q, t),
            lie.se3_inverse(lie.SE3(ms.kf_q[ref], ms.kf_t[ref])))
        vec = jnp.concatenate([
            q, t, vel.q, vel.t, rel.q, rel.t,
            jnp.stack([n_in.astype(jnp.float32),
                       widened.astype(jnp.float32),
                       n_m.astype(jnp.float32)]),
            q_pred, t_pred])
        # chain state for the NEXT frame (device-resident): failed frames
        # heal to the predicted pose with velocity/has_vel unchanged —
        # exactly the host state machine's failure branch
        okf = n_in >= cfg.min_track_inliers_lost
        chain_q = jnp.where(okf, q, q_pred)
        chain_t = jnp.where(okf, t, t_pred)
        chain_vq = jnp.where(okf, vel.q, vel_q)
        chain_vt = jnp.where(okf, vel.t, vel_t)
        chain_has_vel = okf | has_vel
        return (ms2, feat_mp, inlier, visible, vec,
                (chain_q, chain_t, chain_vq, chain_vt, chain_has_vel))

    @jax.jit
    def track_ref_kf(ms, frame, ref_kf, q0, t0, cam_params):
        """TrackReferenceKeyFrame fallback (reference src/Tracking.cc:2640):
        BoW-style brute-force match of the frame against the reference
        keyframe's map-point features, then motion-only pose optimization
        seeded from the last pose.  Rescues frames the motion model loses
        (fast rotation, projection drift)."""
        cam = cam_mod.Camera(cam_params, kind)
        bits_f = M.unpack_desc(frame.desc)
        bits_r = M.unpack_desc(ms.kf_feat_desc[ref_kf])
        has_r = ms.kf_feat_valid[ref_kf] & (ms.kf_feat_mp[ref_kf] >= 0)
        res = M.search_by_brute_force(
            bits_f, frame.valid, frame.angle,
            bits_r, has_r, ms.kf_feat_angle[ref_kf])
        mp = ms.kf_feat_mp[ref_kf][jnp.clip(res.idx, 0)]
        ok = res.ok & (mp >= 0) & ms.mp_valid[jnp.clip(mp, 0)] & frame.valid
        feat_mp = jnp.where(ok, mp, S.NO_MP)
        q, t, inlier, n_in = steps.track_pose(ms, frame, feat_mp, q0, t0,
                                              cam, is2)
        return feat_mp, q, t, inlier, n_in, jnp.sum(ok.astype(jnp.int32))

    @jax.jit
    def update_found_visible(ms, feat_mp, inlier, visible):
        P = ms.mp_valid.shape[0]
        mp = jnp.clip(feat_mp, 0)
        found_add = jnp.zeros((P,), jnp.float32).at[mp].add(
            jnp.where((feat_mp >= 0) & inlier, 1.0, 0.0))
        vis_add = visible.astype(jnp.float32) + (found_add > 0)
        return ms._replace(mp_found=ms.mp_found + found_add,
                           mp_visible=ms.mp_visible + jnp.minimum(vis_add, 1.0))

    @jax.jit
    def init_match(frame1, frame2):
        bits1 = M.unpack_desc(frame1.desc)
        bits2 = M.unpack_desc(frame2.desc)
        return M.search_for_initialization(
            frame1.uv, bits1, frame1.angle, frame1.valid,
            frame2.uv, bits2, frame2.angle, frame2.valid,
            window=100.0, ratio=0.9)

    @jax.jit
    def reconstruct(uv1, uv2, valid, Kmat, key):
        return twoview.reconstruct_two_views(uv1, uv2, valid, Kmat, key)

    @jax.jit
    def triangulate_step(ms, kf1, kf2, map_id):
        ok, X, f1, f2 = steps.triangulate_with_neighbor(ms, kf1, kf2, kind,
                                                        s2)
        ms, n_drop = steps.add_triangulated_points(ms, kf1, kf2, ok, X,
                                                   f1, f2, map_id)
        ms = S.update_covis_for_kf(ms, kf1)
        return ms, jnp.sum(ok.astype(jnp.int32)), n_drop

    @jax.jit
    def triangulate_multi_step(ms, kf, neighbors, neighbors_ok, map_id):
        """CreateNewMapPoints against ALL covisible neighbors in ONE
        device program (the reference's sequential per-neighbor loop,
        src/LocalMapping.cc:504-828, cost 8 dispatches here before).
        A feature triangulated by several neighbors keeps its FIRST
        (best-covisible) neighbor — the sequential semantics."""
        ok, X, f1, f2 = jax.vmap(
            lambda k2: steps.triangulate_with_neighbor(ms, kf, k2, kind,
                                                       s2))(neighbors)
        ok = ok & neighbors_ok[:, None]
        first = jnp.argmax(ok, axis=0)                      # [F]
        any_ok = jnp.any(ok, axis=0)
        Fidx = jnp.arange(ok.shape[1], dtype=jnp.int32)
        ms, n_drop = steps.add_triangulated_points(
            ms, kf, neighbors[first], any_ok, X[first, Fidx],
            Fidx, f2[first, Fidx], map_id)
        ms = S.update_covis_for_kf(ms, kf)
        return ms, jnp.sum(any_ok.astype(jnp.int32)), n_drop

    @jax.jit
    def fuse_step(ms, kf, mp_mask):
        ms, n, _ = steps.fuse_into_kf(ms, kf, mp_mask, kind, W, H, sf)
        ms = S.rebuild_reverse_obs(ms)
        ms = S.update_covis_for_kf(ms, kf)
        return ms, n

    @jax.jit
    def refresh_stats(ms, mp_mask):
        return S.refresh_mp_stats(ms, mp_mask, sf)

    def _lba_core(ms, opt_mask):
        """Shared windowed-BA body on the dense reduced-camera solver
        (solvers/ba_window.py run_window_ba_dense): assemble the pm-only
        two-view problem, robust LM + inlier-only polish, write back, drop
        outlier observations with a targeted reverse-obs repair."""
        prob = steps.build_window_problem(ms, opt_mask, is2,
                                          cfg.lba_cam_cap, cfg.lba_pt_cap,
                                          with_cm=False)
        res = bw.run_window_ba_dense(prob, kind, iters=cfg.lba_iters)
        # inlier-floor guard: a badly initialized window classifies (almost)
        # every edge as outlier; polishing on an empty edge set and then
        # dropping 100% of the observations would destroy the region.  When
        # the surviving-inlier fraction is below the floor, keep the full
        # robust edge set for the polish and skip the observation drop
        # entirely (the reference keeps edges and retries next epoch,
        # src/Optimizer.cc:3505 area never empties a window).
        n_valid = jnp.sum(prob.pm_valid.astype(jnp.int32))
        frac_in = (jnp.sum(res.pm_inlier.astype(jnp.int32))
                   / jnp.maximum(n_valid, 1).astype(jnp.float32))
        healthy = frac_in >= 0.4
        polish_mask = res.pm_inlier | (~healthy & prob.pm_valid)
        # robust=True is exact on true inliers (chi2<=delta2 => Huber w=1),
        # and keeps the unhealthy branch from diverging
        res2 = bw.run_window_ba_dense(
            prob._replace(cam_q=res.cam_q, cam_t=res.cam_t, pts=res.pts),
            kind, iters=cfg.lba_polish_iters,
            pm_edge_mask=polish_mask, robust=True)
        # drop observations whose edges were classified outliers — gated on
        # the final inlier fraction clearing the floor
        frac_fin = (jnp.sum(res2.pm_inlier.astype(jnp.int32))
                    / jnp.maximum(n_valid, 1).astype(jnp.float32))
        drop = prob.pm_valid & ~res2.pm_inlier & (frac_fin >= 0.4)
        ms = steps.apply_window_result(ms, prob, res2, drop_pm=drop)
        ms = steps.repair_window_reverse_obs(ms, prob, drop)
        return ms, steps.window_pt_mask(ms, prob)

    def _window_mask(ms, center_kf):
        idx, w, ok = S.best_covisible(ms, center_kf, cfg.lba_window)
        opt_mask = jnp.zeros((ms.kf_valid.shape[0],), bool).at[
            jnp.where(ok, idx, center_kf)].set(True).at[center_kf].set(True)
        return opt_mask & ms.kf_valid

    @jax.jit
    def local_ba(ms, center_kf):
        opt_mask = _window_mask(ms, center_kf)
        # keep the center KF's map origin (its two OLDEST keyframes by
        # kf_seq — slots recycle) fixed — per-map gauge anchors (the
        # reference fixes the map-origin KFs)
        in_map = ms.kf_valid & (ms.kf_map == ms.kf_map[center_kf])
        seq = jnp.where(in_map, ms.kf_seq, S.BIG_SEQ)
        anchor1 = jnp.argmin(seq)
        anchor2 = jnp.argmin(seq.at[anchor1].set(S.BIG_SEQ))
        opt_mask = opt_mask.at[anchor1].set(False).at[anchor2].set(False)
        return _lba_core(ms, opt_mask)[0]

    @jax.jit
    def welding_ba(ms, center_kf, adjust_side):
        """Merge-welding BA (reference merge overload of
        Optimizer::LocalBundleAdjustment, src/Optimizer.cc:3505): the
        covisible window of the merging KF restricted to ``adjust_side``
        (the absorbed map's keyframes) is optimized; merge-target-side
        keyframes observing the fused points stay fixed and provide the
        gauge — exactly the reference's vpAdjustKF vs vpFixedKF split.
        Also returns the welded point mask (the reference's
        spLocalWindowMPs) so _merge_pgo can exclude already-optimized
        points from the remainder Sim3 transport."""
        opt_mask = _window_mask(ms, center_kf) & adjust_side
        ms, pt_free = _lba_core(ms, opt_mask)
        return ms, opt_mask, pt_free

    @jax.jit
    def global_ba(ms, map_id):
        """Full-map BA (reference RunGlobalBundleAdjustment :3579; 10
        iters).  Synchronous epoch — no catch-up propagation needed."""
        in_map = ms.kf_valid & (ms.kf_map == map_id)
        anchor1 = jnp.argmin(jnp.where(in_map, ms.kf_seq, S.BIG_SEQ))
        opt_mask = in_map.at[anchor1].set(False)
        prob = steps.build_window_problem(ms, opt_mask, is2,
                                          cfg.max_kf, cfg.max_mp,
                                          with_cm=False)
        res = bw.run_window_ba_dense(prob, kind, iters=10)
        ms = steps.apply_window_result(ms, prob, res)
        return ms

    @jax.jit
    def kf_redundancy(ms, kf):
        return steps.keyframe_redundancy(ms, kf)

    @jax.jit
    def remove_kf(ms, kf):
        return S.remove_keyframe(ms, kf)

    @jax.jit
    def cull_map_points(ms, current_kf):
        """MapPointCulling scoped to the current KF's creating agent
        (reference agent-aware recency windows, LocalMapping.cc:488-495:
        a LocalMapping epoch only culls points ITS agent created, and the
        recency window counts that agent's own per-agent KF ids — so
        interleaved agents never age each other's fresh triangulations)."""
        same_agent = ms.mp_first_agent == ms.kf_agent[current_kf]
        ratio = ms.mp_found / jnp.maximum(ms.mp_visible, 1.0)
        # age in THIS agent's KF insertions (per-agent sequential id)
        age = ms.kf_agent_kf_id[current_kf] - ms.mp_first_agent_kf
        young_dead = (age >= 2) & (age <= 4) & (ms.mp_nobs <= 2)
        weak = (ratio < 0.25) & (ms.mp_visible >= 4)
        kill = ms.mp_valid & same_agent & (weak | young_dead)
        return S.remove_map_points(ms, kill), jnp.sum(kill.astype(jnp.int32))

    @jax.jit
    def create_initial_map(ms, frame1, frame2, q2, t2, mp_src_feat1,
                           mp_src_feat2, mp_ok, X, cam_params, map_id,
                           agent, ts1, ts2):
        """Two keyframes + triangulated points + wiring (reference
        Tracking::CreateInitialMapMonocular)."""
        F = frame1.uv.shape[0]
        ms, kf1 = S.add_keyframe(
            ms, lie.quat_identity(), jnp.zeros(3), agent, map_id, ts1, 0,
            frame1.uv, frame1.level, frame1.angle, frame1.desc,
            frame1.valid, jnp.full((F,), S.NO_MP, jnp.int32),
            cam_params=cam_params)
        ms, kf2 = S.add_keyframe(
            ms, q2, t2, agent, map_id, ts2, 1,
            frame2.uv, frame2.level, frame2.angle, frame2.desc,
            frame2.valid, jnp.full((F,), S.NO_MP, jnp.int32),
            cam_params=cam_params)
        ms, _ = steps.add_triangulated_points(ms, kf1, kf2, mp_ok, X,
                                              mp_src_feat1, mp_src_feat2,
                                              map_id)
        ms = S.update_covis_for_kf(ms, kf2)
        ms = S.update_covis_for_kf(ms, kf1)
        ms = S.refresh_mp_stats(ms, ms.mp_valid, sf)
        ms = ms._replace(map_valid=ms.map_valid.at[map_id].set(True))
        return ms, kf1, kf2

    @jax.jit
    def initial_gba_and_rescale(ms, kf1, map_id):
        """20-iteration full BA on the new 2-KF map then inverse-median-
        depth normalization (reference :2498-2531).  Scoped to `map_id` so
        later agents' initializations never touch existing maps."""
        in_map_kf = ms.kf_valid & (ms.kf_map == map_id)
        in_map_mp = ms.mp_valid & (ms.mp_map == map_id)
        opt_mask = in_map_kf.at[kf1].set(False)
        prob = steps.build_window_problem(ms, opt_mask, is2, 4, cfg.n_feat,
                                          with_cm=False)
        res = bw.run_window_ba_dense(prob, kind, iters=20)
        ms = steps.apply_window_result(ms, prob, res)
        # median depth in the first KF's frame
        Xc = lie.quat_rotate(ms.kf_q[kf1][None], ms.mp_pos) + ms.kf_t[kf1][None]
        depths = jnp.where(in_map_mp, Xc[:, 2], jnp.nan)
        med = jnp.nanmedian(depths)
        inv = 1.0 / jnp.maximum(med, 1e-6)
        ms = ms._replace(
            mp_pos=jnp.where(in_map_mp[:, None], ms.mp_pos * inv,
                             ms.mp_pos),
            kf_t=jnp.where(in_map_kf[:, None], ms.kf_t * inv, ms.kf_t),
            # scale-invariance distance bounds scale with the map
            mp_min_dist=jnp.where(in_map_mp, ms.mp_min_dist * inv,
                                  ms.mp_min_dist),
            mp_max_dist=jnp.where(in_map_mp, ms.mp_max_dist * inv,
                                  ms.mp_max_dist))
        ms = S.refresh_mp_stats(ms, in_map_mp, sf)
        ok = (med > 1e-3) & (jnp.sum(in_map_mp) > 50)
        return ms, ok

    @jax.jit
    def add_kf_step(ms, frame, q, t, feat_mp, agent, map_id, ts,
                    agent_kf_id, cam_params):
        ms, kf = S.add_keyframe(ms, q, t, agent, map_id, ts, agent_kf_id,
                                frame.uv, frame.level, frame.angle,
                                frame.desc, frame.valid, feat_mp,
                                cam_params=cam_params)
        touched = jnp.zeros((ms.mp_valid.shape[0],), bool).at[
            jnp.clip(feat_mp, 0)].set(feat_mp >= 0)
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(touched, cfg.n_feat), sf)
        return ms, kf

    @jax.jit
    def mapping_epoch(ms, kf, map_id, protected_extra):
        """The full per-KF LocalMapping body (reference
        LocalMapping::Run, src/LocalMapping.cc:77-390) as ONE device
        program: MP culling -> 8-neighbor triangulation -> compact stat
        refresh -> fuse -> windowed LBA.  One dispatch instead of ~10;
        stat refreshes are compact (the epoch touches O(F) points, the
        reference updates per-point — recomputing the full arena wasted
        P/F of the work).  Also returns the top-10 covisibles for the
        host's KeyFrameCulling decision (saves another round trip)."""
        ms, n_culled = cull_map_points(ms, kf)
        nb_idx, nb_w, nb_ok = S.best_covisible(
            ms, kf, cfg.n_triangulate_neighbors)
        before = ms.mp_valid
        ms, n_new, n_drop = triangulate_multi_step(ms, kf, nb_idx, nb_ok,
                                                   map_id)
        new_pts = ms.mp_valid & ~before
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(new_pts, cfg.n_feat), sf)
        local_mask = local_mp_mask(ms, kf, 16)
        ms, n_fused, touched = steps.fuse_into_kf(ms, kf, local_mask,
                                                  kind, W, H, sf)
        ms = S.rebuild_reverse_obs(ms)
        ms = S.update_covis_for_kf(ms, kf)
        # cap = true worst case: F fresh triangulations + F fuse-added
        # observations + F replace survivors can all be distinct points
        ms = S.refresh_mp_stats_compact(
            ms, S.compact_indices(touched | new_pts, 3 * cfg.n_feat), sf)
        ms = local_ba(ms, kf)
        counts = jnp.stack([n_culled, n_new, n_drop, n_fused]
                           ).astype(jnp.float32)
        row0 = jnp.concatenate([counts, jnp.zeros(8)])[None]
        # row 0 = epoch counters, rows 1..10 = culling pack — the host
        # fetches ONE [11, 12] array per mapping epoch
        return ms, jnp.concatenate(
            [row0, cull_pack(ms, kf, protected_extra)], axis=0)

    @jax.jit
    def cull_pack(ms, kf, protected_extra):
        """Everything the host's KeyFrameCulling decision needs, as ONE
        [10, 12] array — one fetch instead of ~8 (each fetch is a full
        host<->device roundtrip; on a high-latency link the old
        fetch-per-field logic cost more than the epoch's compute).
        Columns: cand_idx, eligible, redundant_frac, n_tracked, parent,
        q_cp (4), t_cp (3) — q_cp/t_cp = pose relative to the spanning
        parent, pre-computed for the culled-ancestor bookkeeping.
        ``protected_extra``: KF slots pinned by the host (agents' current
        reference KFs)."""
        idx, w, ok = S.best_covisible(ms, kf, 10)
        idxc = jnp.clip(idx, 0)
        frac, ntr = jax.vmap(
            lambda c: steps.keyframe_redundancy(ms, jnp.clip(c, 0)))(idx)
        # protected: self, per-map gauge anchors (2 oldest), loop/merge
        # edge endpoints (SetNotErase analog), host-pinned refs
        in_map = ms.kf_valid & (ms.kf_map == ms.kf_map[kf])
        seq = jnp.where(in_map, ms.kf_seq, S.BIG_SEQ)
        a1 = jnp.argmin(seq)
        a2 = jnp.argmin(seq.at[a1].set(S.BIG_SEQ))
        K = ms.kf_valid.shape[0]
        lv = ms.loop_valid
        loop_ep = (jnp.zeros((K,), bool)
                   .at[jnp.clip(ms.loop_i, 0)].max(lv)
                   .at[jnp.clip(ms.loop_j, 0)].max(lv))
        prot = ((idx == kf) | (idx == a1) | (idx == a2) | loop_ep[idxc]
                | jnp.any(idx[:, None] == protected_extra[None, :],
                          axis=1))
        par = ms.kf_parent[idxc]
        parc = jnp.clip(par, 0)
        T_cp = jax.vmap(lambda c, p: lie.se3_compose(
            lie.SE3(ms.kf_q[c], ms.kf_t[c]),
            lie.se3_inverse(lie.SE3(ms.kf_q[p], ms.kf_t[p]))))(idxc, parc)
        f32 = jnp.float32
        return jnp.concatenate([
            idx.astype(f32)[:, None], (ok & ~prot).astype(f32)[:, None],
            frac[:, None], ntr.astype(f32)[:, None],
            par.astype(f32)[:, None], T_cp.q, T_cp.t], axis=1)

    @jax.jit
    def kf_redundancy_batch(ms, cands, cand_ok):
        """Redundancy stats for ALL culling candidates in one dispatch
        (the per-candidate host loop paid a launch each)."""
        frac, ntr = jax.vmap(
            lambda c: steps.keyframe_redundancy(ms, jnp.clip(c, 0)))(cands)
        return (jnp.where(cand_ok, frac, 0.0),
                jnp.where(cand_ok, ntr, 0))

    return dict(match_and_pose=match_and_pose, track_ref_kf=track_ref_kf,
                track_frame_step=track_frame_step,
                local_mp_mask=local_mp_mask,
                kf_redundancy=kf_redundancy, remove_kf=remove_kf,
                global_ba=global_ba, mapping_epoch=mapping_epoch,
                cull_pack=cull_pack,
                kf_redundancy_batch=kf_redundancy_batch,
                update_found_visible=update_found_visible,
                init_match=init_match, reconstruct=reconstruct,
                triangulate_step=triangulate_step,
                triangulate_multi_step=triangulate_multi_step,
                fuse_step=fuse_step,
                refresh_stats=refresh_stats, local_ba=local_ba,
                welding_ba=welding_ba,
                cull_map_points=cull_map_points,
                create_initial_map=create_initial_map,
                initial_gba_and_rescale=initial_gba_and_rescale,
                add_kf_step=add_kf_step)


@dataclass
class AgentState:
    """Per-agent tracking state (reference Agent + Tracking fields)."""

    agent_id: int
    cam: cam_mod.Camera
    state: int = NO_IMAGES_YET
    map_id: int = 0
    q: Optional[jnp.ndarray] = None       # current T_cw
    t: Optional[jnp.ndarray] = None
    vel_q: Optional[jnp.ndarray] = None   # constant-velocity model
    vel_t: Optional[jnp.ndarray] = None
    # mono-inertial state (reference Tracking mono-IMU plumbing,
    # src/Tracking.cc:1633 PreintegrateIMU + PredictStateIMU): world
    # velocity + gyro/acc biases, body frame == camera frame (Tbc = I)
    imu_calib: Optional[object] = None    # solvers.imu.ImuCalib
    vel_w: Optional[np.ndarray] = None    # [3] world velocity (map units/s)
    bias_g: Optional[np.ndarray] = None
    bias_a: Optional[np.ndarray] = None
    # mono-inertial initialization state (reference
    # LocalMapping::InitializeIMU): the monocular map is median-depth-
    # rescaled and its world frame is the first camera pose — neither
    # metric nor gravity-aligned — so IMU prediction is GATED on a
    # successful gravity/scale/bias estimate over a buffered window.
    # Until then tracking falls back to the constant-velocity model.
    imu_initialized: bool = False
    imu_init_map: int = -1                # map the estimate belongs to
    imu_scale: float = 1.0                # metres per map unit
    gravity_w: Optional[np.ndarray] = None  # metric gravity in map frame
    imu_buf: List = field(default_factory=list)  # (ts, q, t, gyro, acc, dts)
    last_ts: Optional[float] = None
    # frames where the tight first-stage search failed and the widened /
    # BoW-fallback stages had to rescue tracking (prediction quality
    # telemetry; IMU prediction should keep this near zero)
    n_fallback: int = 0
    # ref-KF-relative pose of the CURRENT frame, produced by the fused
    # tracking step (trajectory writer uses it without device math);
    # None on frames that didn't run the fused success path
    last_rel: Optional[tuple] = None
    # deferred per-frame results awaiting their state-machine pass, in
    # dispatch order (SlamSystem.pipeline mode; length <= pipeline_depth)
    pending_q: List = field(default_factory=list)
    # device-resident (q, t, vel_q, vel_t, has_vel) chain feeding the
    # next frame's in-device prediction without any host readback; None
    # => next dispatch uploads the host-side pose (after reloc / map
    # switch / rescue, where the host view diverges from the chain)
    dev_chain: Optional[tuple] = None
    last_frame: Optional[steps.FrameObs] = None
    last_feat_mp: Optional[jnp.ndarray] = None
    init_frame: Optional[steps.FrameObs] = None
    ref_kf: int = -1
    ref_kf_tracked: int = 0
    frames_since_kf: int = 0
    kf_insertions_refused: int = 0
    next_agent_kf_id: int = 0
    frames_lost: int = 0
    trajectory: List = field(default_factory=list)  # (ts, ref_kf, q_rel, t_rel, state)
    times_ms: List = field(default_factory=list)


class SlamSystem:
    """Single-host system: shared MapState + N agents (MultiAgentSystem).

    ``async_mapping=True`` decouples the tracking front end from the
    mapping/server back end the way the reference's per-agent
    LocalMapping threads do (SURVEY §2.6: KF queues + mMutexLocalMap):
    a single worker thread drains a bounded job queue and is the only
    *structural* writer of ``self.ms``; tracking reads one immutable
    snapshot per frame (functional state makes this free) and inserts
    keyframes only when the worker is idle — a busy worker refuses the
    insertion, incrementing the agent's refused-insertions counter
    (the reference's ``SetAcceptKeyFrames(false)`` /
    ``mnKFinsertionsRefusedSinceLast`` back-pressure,
    src/LocalMapping.cc:995-1013).
    """

    def __init__(self, cfg: SlamConfig, cam: cam_mod.Camera, seed: int = 0,
                 async_mapping: bool = False):
        self.cfg = cfg
        self.ms = S.init_map_state(cfg.map_config())
        self.cam = cam
        self.fns = _compiled(cfg, cfg.cam_kind)
        self.agents: List[AgentState] = []
        self.key = jax.random.PRNGKey(seed)
        self.events: List[str] = []
        self.mp_dropped = 0  # triangulations dropped on arena overflow
        self.server = None  # optional LoopServer (slam/server.py)
        self.timers = Timers()  # LM/tracking stage series (SURVEY §5)
        # culled KF -> (parent, q_rel, t_rel): pose relative to spanning-
        # tree parent at cull time, so trajectory rows referencing culled
        # KFs resolve through live ancestors (reference Agent::
        # SaveTrajectory walks mTcp up the tree, src/Agent.cc:228-341)
        self.culled_kf = {}
        # epoch counter bumped on every structural map mutation (KF/MP
        # add/remove/correction); tracking validates its snapshot against
        # it before wiring new-KF observations
        self.ms_epoch = 0
        # pipelined tracking: defer each frame's result fetch + state
        # machine by up to ``pipeline_depth`` frames so the D2H readback
        # overlaps useful work (consecutive frames chain their pose
        # prediction device-to-device).  track() then returns a lagged
        # state view; call drain() before reading final poses /
        # trajectories.  Depth 1 = classic one-frame lag; deeper depths
        # hide multi-roundtrip link latencies entirely.
        self.pipeline = False
        self.pipeline_depth = 1
        self.async_mapping = async_mapping
        self._worker_error = None
        # mapping jobs queued or being processed by the worker — the
        # back-pressure signal for KF insertion (stats-delta jobs hold
        # the lock only microseconds and must NOT refuse insertions)
        self._pending_mapping = 0
        if async_mapping:
            import queue as _queue
            import threading as _threading
            self._ms_lock = _threading.Lock()
            self._jobs = _queue.Queue(maxsize=8)
            self._worker = _threading.Thread(
                target=self._mapping_worker, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _mapping_worker(self):
        """Back-end thread: applies tracking stats deltas and runs the
        mapping pipeline + centralized server per queued keyframe."""
        while True:
            job = self._jobs.get()
            if job is None:
                self._jobs.task_done()
                return
            try:
                with self._ms_lock:
                    if job[0] == "stats":
                        # stats deltas index MP slots of the snapshot they
                        # were computed on; a mapping job in between may
                        # have culled + recycled those slots — drop stale
                        # deltas (they are acknowledged heuristics)
                        _, epoch, payload = job
                        if epoch == self.ms_epoch:
                            self.ms = self.fns["update_found_visible"](
                                self.ms, *payload)
                    else:  # ("mapping", agent_id, kf)
                        _, aid, kf = job
                        a = self.agents[aid]
                        try:
                            self._local_mapping(a, kf)
                            self.ms_epoch += 1
                            if self.server is not None:
                                self.server.process_keyframe(aid, kf)
                                self.ms_epoch += 1
                        finally:
                            self._pending_mapping -= 1
            except Exception as e:  # surfaced by flush()
                self._worker_error = e
            finally:
                self._jobs.task_done()

    def flush(self):
        """Drain the mapping queue (and any pending background GBA);
        re-raises worker exceptions.  No-op for synchronous systems."""
        self.drain()
        if self.async_mapping:
            self._jobs.join()
        if self.server is not None:
            self.server.flush_gba()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def shutdown(self):
        self.flush()
        if self.async_mapping:
            self._jobs.put(None)
            self._worker.join(timeout=30)

    def add_agent(self, cam: Optional[cam_mod.Camera] = None) -> int:
        """Register an agent; `cam` allows per-agent intrinsics (same
        camera kind and image geometry across agents in this build)."""
        a = AgentState(agent_id=len(self.agents),
                       cam=self.cam if cam is None else cam)
        a.map_id = self._alloc_map_id()
        self.agents.append(a)
        return a.agent_id

    def _alloc_map_id(self) -> int:
        """Lowest free atlas map slot (slots of merged-away maps recycle).

        Map ids previously grew unbounded while ``map_valid`` has
        ``max_maps`` slots — the 9th map's scatter silently dropped under
        jit.  Exhaustion now fails loudly instead."""
        used = {a.map_id for a in self.agents if a.map_id >= 0}
        mv = np.asarray(self.ms.map_valid)
        for m in range(mv.shape[0]):
            if not mv[m] and m not in used:
                return m
        raise MapCapacityError(
            f"atlas exhausted: all {mv.shape[0]} map slots live "
            f"(raise MapConfig.max_maps)")

    # ------------------------------------------------------------------
    def track(self, agent_id: int, frame: steps.FrameObs, ts: float,
              imu=None):
        """Process one frame for one agent; returns (state, T_cw or None).

        The reference's Tracking::Track state machine (src/Tracking.cc:1803).
        ``imu``: optional (gyro [N,3], acc [N,3], dts [N]) measurements
        since the previous frame — enables IMU state prediction in place
        of the constant-velocity model (mono-inertial tracking; reference
        PreintegrateIMU/PredictStateIMU, src/Tracking.cc:1633,2060)."""
        import time
        t0 = time.perf_counter()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err
        a = self.agents[agent_id]
        # complete deferred frames down to the lag bound (deterministic:
        # oldest-first whenever the queue is at depth)
        while len(a.pending_q) >= max(self.pipeline_depth, 1):
            self._complete_pending(a)
        if a.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            self.drain_agent(a)
            a.last_rel = None
            self._monocular_initialization(a, frame, ts)
            self._post_frame(a, frame, ts, t0)
        else:
            self._track_frame(a, frame, ts, imu=imu, t0=t0)
            if not self.pipeline:
                self._post_frame(a, frame, ts, t0)
        return a.state, (a.q, a.t) if a.q is not None else None

    def _post_frame(self, a: AgentState, frame, ts, t0):
        import time
        a.last_frame = frame
        a.times_ms.append((time.perf_counter() - t0) * 1e3)
        if a.q is not None:
            self._record_trajectory(a, ts)
        a.last_ts = ts

    def _complete_pending(self, a: AgentState):
        """Finish the deferred state machine of the OLDEST in-flight
        frame (pipelined mode): fetch its packed result — the D2H copy
        has been in flight since dispatch — and run decisions."""
        pend = a.pending_q.pop(0)
        a.last_rel = None
        self._finish_frame(a, pend)
        self._post_frame(a, pend["frame"], pend["ts"], pend["t0"])

    def drain_agent(self, a: AgentState):
        while a.pending_q:
            self._complete_pending(a)

    def drain(self):
        """Complete every agent's pending pipelined frames (call before
        reading trajectories/poses or shutting down)."""
        for a in self.agents:
            self.drain_agent(a)

    @staticmethod
    def _default_imu_calib():
        from mam3slam_tpu.solvers import imu as imu_mod
        return imu_mod.ImuCalib(
            sigma_g=jnp.asarray(1.7e-4), sigma_a=jnp.asarray(2e-3),
            walk_g=jnp.asarray(1.9e-5), walk_a=jnp.asarray(3e-3))

    def _imu_predict(self, a: AgentState, imu, dt_total: float):
        """Navigation-state prediction through the preintegrated IMU
        window (reference Tracking::PredictStateIMU): returns predicted
        (q_cw, t_cw) from the last pose + world-velocity estimate.

        Only called after mono-inertial initialization: the prediction is
        run in METRIC units (nav state scaled by ``imu_scale``) under the
        estimated map-frame gravity, then mapped back to map units."""
        from mam3slam_tpu.solvers import imu as imu_mod

        gyro, acc, dts = imu
        calib = a.imu_calib or self._default_imu_calib()
        bg = jnp.zeros(3) if a.bias_g is None else jnp.asarray(a.bias_g)
        ba = jnp.zeros(3) if a.bias_a is None else jnp.asarray(a.bias_a)
        pre = imu_mod.preintegrate(
            jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dts),
            jnp.ones(len(dts), bool), bg, ba, calib)
        R_cw = lie.quat_to_matrix(a.q)
        R_wb = R_cw.T                       # body frame == camera frame
        C = -R_wb @ a.t
        v_w = jnp.zeros(3) if a.vel_w is None else jnp.asarray(a.vel_w)
        s = a.imu_scale
        g_w = (jnp.asarray(a.gravity_w) if a.gravity_w is not None
               else jnp.asarray([0.0, 0.0, -imu_mod.GRAVITY]))
        R2, v2, p2 = imu_mod.predict_state(pre, R_wb, s * v_w, s * C,
                                           bg, ba, gravity=g_w)
        q_pred = lie.quat_from_matrix(R2.T)
        t_pred = -R2.T @ (p2 / s)
        return q_pred, t_pred

    def _imu_buffer_and_init(self, a: AgentState, ts: float, imu):
        """Accumulate successfully-tracked (pose, IMU-window) pairs and,
        once the buffer spans ``imu_init_window_s`` of contiguous
        tracking, run the mono-inertial initialization (reference
        LocalMapping::InitializeIMU -> InertialOptimization): the visual
        poses are held fixed while gravity direction, map scale, shared
        biases and per-state velocities are estimated."""
        gyro, acc, dts = (np.asarray(imu[0], np.float32),
                          np.asarray(imu[1], np.float32),
                          np.asarray(imu[2], np.float32))
        a.imu_buf.append((ts, np.asarray(a.q, np.float32),
                          np.asarray(a.t, np.float32), gyro, acc, dts))
        if len(a.imu_buf) > 64:
            a.imu_buf = a.imu_buf[-64:]
        if a.imu_initialized and a.imu_init_map == a.map_id:
            return
        cfg = self.cfg
        if (len(a.imu_buf) < 8
                or a.imu_buf[-1][0] - a.imu_buf[0][0]
                < cfg.imu_init_window_s):
            return
        from mam3slam_tpu.solvers import imu as imu_mod
        from mam3slam_tpu.solvers import vi as vi_mod

        buf = a.imu_buf
        # subsample to <= 16 nav states; the IMU samples between two
        # selected states are concatenated (preintegration over the
        # merged window == merged preintegration)
        K = len(buf)
        sel = np.unique(np.linspace(0, K - 1, min(K, 16)).round()
                        .astype(int))
        segs = []
        for m in range(len(sel) - 1):
            lo, hi = sel[m], sel[m + 1]
            g = np.concatenate([buf[i][3] for i in range(lo + 1, hi + 1)])
            ac = np.concatenate([buf[i][4] for i in range(lo + 1, hi + 1)])
            dt = np.concatenate([buf[i][5] for i in range(lo + 1, hi + 1)])
            segs.append((g, ac, dt))
        Lmax = max(s_[0].shape[0] for s_ in segs)
        E = len(segs)
        G = np.zeros((E, Lmax, 3), np.float32)
        Ac = np.zeros((E, Lmax, 3), np.float32)
        Dt = np.zeros((E, Lmax), np.float32)
        Vm = np.zeros((E, Lmax), bool)
        for m, (g, ac, dt) in enumerate(segs):
            n = g.shape[0]
            G[m, :n], Ac[m, :n], Dt[m, :n], Vm[m, :n] = g, ac, dt, True
        calib = a.imu_calib or self._default_imu_calib()
        z3 = jnp.zeros(3)
        pre_b = jax.vmap(lambda g, ac, dt, v: imu_mod.preintegrate(
            g, ac, dt, v, z3, z3, calib))(
            jnp.asarray(G), jnp.asarray(Ac), jnp.asarray(Dt),
            jnp.asarray(Vm))
        Ks = len(sel)
        iedges = vi_mod.InertialEdges(
            i=jnp.arange(Ks - 1, dtype=jnp.int32),
            j=jnp.arange(1, Ks, dtype=jnp.int32),
            preint=pre_b, valid=jnp.ones(Ks - 1, bool))
        q_s = jnp.asarray(np.stack([buf[i][1] for i in sel]))
        t_s = jnp.asarray(np.stack([buf[i][2] for i in sel]))
        Rwg, s, bg, ba, vel = vi_mod.inertial_optimization(
            q_s, t_s, jnp.ones(Ks, bool), iedges, calib,
            fix_scale=False, iters=40)
        s_f = float(s)
        ok = (np.isfinite(s_f) and 0.02 < s_f < 50.0
              and bool(jnp.all(jnp.isfinite(bg)))
              and bool(jnp.all(jnp.isfinite(ba)))
              and bool(jnp.all(jnp.isfinite(vel))))
        if not ok:
            # drop the oldest half and retry later with fresh data
            a.imu_buf = a.imu_buf[len(a.imu_buf) // 2:]
            return
        a.bias_g = np.asarray(bg, np.float32)
        a.bias_a = np.asarray(ba, np.float32)
        a.imu_scale = s_f
        a.gravity_w = np.asarray(
            Rwg @ jnp.asarray([0.0, 0.0, -imu_mod.GRAVITY]), np.float32)
        a.vel_w = np.asarray(vel[-1], np.float32) / s_f  # map units/s
        a.imu_initialized = True
        a.imu_init_map = a.map_id
        self.events.append(
            f"IMU_INIT agent={a.agent_id} map={a.map_id} "
            f"scale={s_f:.4f}")

    # ------------------------------------------------------------------
    def _monocular_initialization(self, a: AgentState, frame, ts):
        cfg = self.cfg
        if a.init_frame is None or a.state == NO_IMAGES_YET:
            a.init_frame = frame
            a.init_ts = ts
            a.state = NOT_INITIALIZED
            return
        res = self.fns["init_match"](a.init_frame, frame)
        n = int(res.ok.sum())
        if n < cfg.min_init_matches:
            a.init_frame = frame  # re-anchor (reference resets initializer)
            a.init_ts = ts
            return
        # compact matched pairs: row i of frame1 matched to idx[i] of frame2
        uv1 = a.init_frame.uv
        uv2 = frame.uv[jnp.clip(res.idx, 0)]
        if a.cam.kind == cam_mod.KANNALA_BRANDT8:
            # two-view H/F machinery is pinhole geometry: lift fisheye
            # keypoints to ideal-pinhole coords first (the reference's
            # KannalaBrandt8::ReconstructWithTwoViews unprojects before
            # running the same RANSAC, src/CameraModels/KannalaBrandt8.cpp)
            uv1 = cam_mod.undistort_points(a.cam, uv1)
            uv2 = cam_mod.undistort_points(a.cam, uv2)
        self.key, sub = jax.random.split(self.key)
        Kmat = a.cam.K()
        rec = self.fns["reconstruct"](uv1, uv2, res.ok, Kmat, sub)
        if not bool(rec.ok):
            return
        q2 = lie.quat_from_matrix(rec.R21)
        t2 = rec.t21
        # structural RMW: serialize against the mapping worker (async)
        import contextlib
        self._kf_capacity_check(2)
        lock = (self._ms_lock if self.async_mapping
                else contextlib.nullcontext())
        with lock:
            ms, kf1, kf2 = self.fns["create_initial_map"](
                self.ms, a.init_frame, frame, q2, t2,
                jnp.arange(cfg.n_feat, dtype=jnp.int32),
                jnp.clip(res.idx, 0), rec.is_triangulated & res.ok,
                rec.points3d, a.cam.params, a.map_id, a.agent_id,
                jnp.asarray(getattr(a, 'init_ts', ts), jnp.float32),
                jnp.asarray(ts, jnp.float32))
            ms, ok = self.fns["initial_gba_and_rescale"](
                ms, kf1, jnp.asarray(a.map_id))
            if not bool(ok):
                return
            self.ms = ms
            self.ms_epoch += 1
        a.state = OK
        a.ref_kf = int(kf2)
        a.q = self.ms.kf_q[a.ref_kf]
        a.t = self.ms.kf_t[a.ref_kf]
        a.last_feat_mp = np.asarray(self.ms.kf_feat_mp[int(kf2)])
        a.vel_q, a.vel_t = None, None
        a.next_agent_kf_id = 2
        a.frames_since_kf = 0
        a.ref_kf_tracked = int((self.ms.kf_feat_mp[int(kf2)] >= 0).sum())
        self.events.append(f"INIT agent={a.agent_id} map={a.map_id} "
                           f"kfs=({int(kf1)},{int(kf2)}) "
                           f"mps={int(self.ms.mp_valid.sum())}")

    # ------------------------------------------------------------------
    def _track_frame(self, a: AgentState, frame, ts, imu=None,
                     t0=None):
        cfg = self.cfg
        # one immutable snapshot per frame: concurrent mapping/server
        # publications (async mode) never shear mid-frame.  Epoch is read
        # BEFORE the snapshot: if a mapping job publishes between the two
        # reads we hold a *newer* ms with an *older* epoch, and the
        # epoch-equality check in _create_keyframe fails conservatively
        # (never the reverse, which would wire stale feat_mp indices into
        # a post-mapping map).
        # external (IMU) prediction needs the host's CURRENT pose — in
        # pipelined mode complete all in-flight frames first (inertial
        # tracking opts into the low-latency path)
        use_imu = (imu is not None and a.q is not None
                   and a.last_ts is not None and a.imu_initialized
                   and a.imu_init_map == a.map_id)
        if use_imu:
            self.drain_agent(a)

        snap_epoch = self.ms_epoch
        ms = self.ms
        id_q = np.array([1, 0, 0, 0], np.float32)
        zero3 = np.zeros(3, np.float32)
        if use_imu:
            q_ext, t_ext = self._imu_predict(a, imu, ts - a.last_ts)
            q_ext = np.asarray(q_ext, np.float32)
            t_ext = np.asarray(t_ext, np.float32)
        else:
            q_ext, t_ext = id_q, zero3

        # chain state: device-resident from the previous step when the
        # host view hasn't diverged, else uploaded from the host pose
        if a.dev_chain is not None:
            q_last, t_last, vel_q, vel_t, has_vel = a.dev_chain
        else:
            q_last = np.asarray(a.q, np.float32)
            t_last = np.asarray(a.t, np.float32)
            if a.vel_q is not None:
                vel_q = np.asarray(a.vel_q, np.float32)
                vel_t = np.asarray(a.vel_t, np.float32)
                has_vel = True
            else:
                vel_q, vel_t, has_vel = id_q, zero3, False

        # the whole per-frame pipeline (prediction, local mask, coarse
        # match+pose, in-device widened retry, fine match+pose, stat
        # deltas, velocity + ref-relative pose) in ONE dispatch
        (ms2, feat_mp, inlier, visible, vec,
         chain) = self.fns["track_frame_step"](
            ms, frame, jnp.asarray(max(a.ref_kf, 0)),
            vel_q, vel_t, jnp.asarray(has_vel) if isinstance(has_vel, bool)
            else has_vel,
            q_last, t_last, q_ext, t_ext, jnp.asarray(use_imu),
            a.cam.params)
        a.dev_chain = chain
        pend = dict(ms=ms, ms2=ms2, feat_mp=feat_mp, inlier=inlier,
                    visible=visible, vec=vec, frame=frame, ts=ts,
                    imu=imu, snap_epoch=snap_epoch, t0=t0,
                    ref_kf=max(a.ref_kf, 0))
        if self.pipeline:
            # defer the fetch + state machine; start the D2H copy now so
            # it rides the link while later frames dispatch
            try:
                vec.copy_to_host_async()
            except Exception:
                pass
            a.pending_q.append(pend)
            return
        self._finish_frame(a, pend)

    def _finish_frame(self, a: AgentState, pend):
        cfg = self.cfg
        ms = pend["ms"]
        frame = pend["frame"]
        ts = pend["ts"]
        imu = pend["imu"]
        snap_epoch = pend["snap_epoch"]
        # sequential finishes: the host pose IS the previous frame's pose
        q_last = np.asarray(a.q, np.float32)
        t_last = np.asarray(a.t, np.float32)
        ms2, feat_mp, inlier, visible = (pend["ms2"], pend["feat_mp"],
                                         pend["inlier"], pend["visible"])
        vec = np.asarray(pend["vec"])
        q, t = vec[0:4], vec[4:7]
        vel_q, vel_t = vec[7:11], vec[11:14]
        q_rel, t_rel = vec[14:18], vec[18:21]
        n_in_i = int(vec[21])
        q_pred, t_pred = vec[24:28], vec[28:31]
        if vec[22]:  # widened-retry telemetry
            a.n_fallback += 1

        if (n_in_i < cfg.min_track_inliers_lost and a.ref_kf >= 0
                and a.state == OK):
            # TrackReferenceKeyFrame fallback (reference :2640): BoW match
            # against the reference KF, pose from the LAST pose (not the
            # possibly-bad motion prediction).  Only from the OK state —
            # when RECENTLY_LOST the reference goes straight to
            # Relocalization (Tracking.cc:1903-1951), which is what
            # enables cross-map re-entry.  Rare — extra dispatches ok.
            feat_mp_r, q_r, t_r, inlier_r, n_r, n_bow = self.fns[
                "track_ref_kf"](ms, frame, jnp.asarray(pend["ref_kf"]),
                                q_last, t_last, a.cam.params)
            if int(n_bow) >= 15 and int(n_r) > n_in_i and int(n_r) >= 10:
                feat_mp, inlier = feat_mp_r, inlier_r
                q = np.asarray(q_r, np.float32)
                t = np.asarray(t_r, np.float32)
                n_in_i = int(n_r)
                a.dev_chain = None  # host pose diverges from the chain
                # recompute velocity + ref-relative pose host-side
                # (same ref as the dispatch-time rel labeling)
                iq, it = _se3_inverse_np(q_last, t_last)
                vel_q, vel_t = _se3_compose_np(q, t, iq, it)
                rq = np.asarray(ms.kf_q[pend["ref_kf"]], np.float32)
                rt = np.asarray(ms.kf_t[pend["ref_kf"]], np.float32)
                irq, irt = _se3_inverse_np(rq, rt)
                q_rel, t_rel = _se3_compose_np(q, t, irq, irt)

        if self.async_mapping:
            # found/visible counters are additive heuristics; apply them
            # serialized through the worker (single-writer discipline)
            try:
                self._jobs.put_nowait(
                    ("stats", snap_epoch, (feat_mp, inlier, visible)))
            except Exception:
                pass  # queue full: drop the delta (pure heuristic)
        elif self.ms is ms:
            # no structural mutation since this frame's snapshot: the
            # stats-applied ms2 is the current state plus the deltas
            self.ms = ms2
        elif snap_epoch == self.ms_epoch:
            # same structure, different array contents (pose updates):
            # re-apply the deltas on the live state
            self.ms = self.fns["update_found_visible"](self.ms, feat_mp,
                                                       inlier, visible)
        # else: deferred frame's snapshot is structurally stale (a KF /
        # mapping epoch landed in between) — drop the heuristic deltas

        threshold = (cfg.min_track_inliers if a.state == OK
                     else cfg.min_track_inliers_lost)
        if n_in_i < threshold:
            if a.state == OK:
                a.state = RECENTLY_LOST
                a.frames_lost = 0
            else:
                a.frames_lost += 1
            # relocalization attempt (BoW over ALL maps — the reference
            # deliberately disables the map filter, enabling cross-map /
            # cross-agent re-entry; src/Tracking.cc:3339,3491)
            if a.state == RECENTLY_LOST and self._relocalize(a, frame):
                a.state = OK
                a.frames_since_kf += 1
                return
            if a.frames_lost > cfg.recently_lost_frames:
                a.state = LOST
                self._create_map_in_atlas(a)
                return
            # keep predicted pose; velocity unchanged.  The pose chain
            # broke — IMU-init buffering needs contiguous tracked poses
            a.imu_buf.clear()
            a.q, a.t = q_pred, t_pred
            a.frames_since_kf += 1
            return

        # success
        if a.state == RECENTLY_LOST:
            a.state = OK
        a.vel_q, a.vel_t = vel_q, vel_t
        # world-velocity estimate for the IMU prediction path
        if a.last_ts is not None and ts > a.last_ts:
            C_old = -_quat_rotate_np(
                np.array([q_last[0], -q_last[1], -q_last[2], -q_last[3]],
                         np.float32), t_last)
            C_new = -_quat_rotate_np(
                np.array([q[0], -q[1], -q[2], -q[3]], np.float32), t)
            a.vel_w = (C_new - C_old) / (ts - a.last_ts)
        a.q, a.t = q, t
        # the relative pose is wrt the DISPATCH-time reference KF (the
        # live a.ref_kf may have advanced under pipelined lag)
        a.last_rel = (q_rel, t_rel, pend["ref_kf"])
        a.last_feat_mp = feat_mp
        a.frames_since_kf += 1
        if imu is not None:
            self._imu_buffer_and_init(a, ts, imu)

        if self._need_new_keyframe(a, n_in_i):
            self._create_keyframe(a, frame, feat_mp, inlier, ts,
                                  snap_epoch=snap_epoch)

    # ------------------------------------------------------------------
    def _relocalize(self, a: AgentState, frame) -> bool:
        """Tracking::Relocalization (:3339): BoW candidates over all maps,
        PnP RANSAC per candidate, pose refinement against the candidate's
        local map; success in a foreign map retargets the agent."""
        if self.server is None or self.server.voc is None:
            return False
        from mam3slam_tpu.ops import bow as bow_mod
        from mam3slam_tpu.solvers import pnp as pnp_mod

        srv = self.server
        if srv.kf_bow_words is None:
            return False
        ms = self.ms
        bits_f = M.unpack_desc(frame.desc)
        words = bow_mod.quantize(srv.voc, bits_f)
        uw, vals = bow_mod.sparse_bow_row(
            srv.voc, np.asarray(words), np.asarray(frame.valid),
            srv.kf_bow_words.shape[1])
        q_dense = jnp.asarray(bow_mod.dense_query(srv.voc, uw, vals))
        db_words = jnp.asarray(srv.kf_bow_words)
        scores = bow_mod.l1_scores_sparse(q_dense, db_words,
                                          jnp.asarray(srv.kf_bow_vals))
        shared = bow_mod.shared_words_sparse(q_dense, db_words)
        # covisibility-group accumulated ranking over ALL maps (reference
        # DetectRelocalizationCandidates applies the same group scoring
        # as loop detection, and deliberately disables the map filter —
        # src/KeyFrameDatabase.cc — enabling cross-map re-entry)
        reps, acc, okc = bow_mod.detect_candidates_grouped(
            scores, shared, ms.kf_valid, ms.covis, n_out=5)
        kf_valid_np = np.asarray(ms.kf_valid)
        cands, seen = [], set()
        for r, o in zip(np.asarray(reps), np.asarray(okc)):
            if not o:
                break
            r = int(r)
            if r not in seen and kf_valid_np[r]:
                seen.add(r)
                cands.append(r)
        for cand in cands:
            has2 = ms.kf_feat_valid[cand] & (ms.kf_feat_mp[cand] >= 0)
            res = M.search_by_brute_force(
                bits_f, frame.valid, frame.angle,
                M.unpack_desc(ms.kf_feat_desc[cand]), has2,
                ms.kf_feat_angle[cand])
            if int(res.ok.sum()) < 15:
                continue
            mp = ms.kf_feat_mp[cand][jnp.clip(res.idx, 0)]
            pts = ms.mp_pos[jnp.clip(mp, 0)]
            ok = res.ok & (mp >= 0) & ms.mp_valid[jnp.clip(mp, 0)]
            self.key, sub = jax.random.split(self.key)
            pr = pnp_mod.ransac_pnp(
                pts, frame.uv, ok, a.cam, sub,
                jnp.asarray(self.cfg.inv_sigma2)[frame.level])
            if not bool(pr.ok):
                continue
            # refine against the candidate's local map
            local_mask = self.fns["local_mp_mask"](ms, jnp.asarray(cand), 32)
            feat_mp, n_m, q, t, inlier, n_in, visible = self.fns[
                "match_and_pose"](ms, frame, pr.q, pr.t, a.cam.params,
                                  local_mask, jnp.asarray(4.0), M.TH_HIGH,
                                  jnp.asarray(0.9))
            if int(n_in) < 30:
                continue
            old_map = a.map_id
            new_map = int(ms.kf_map[cand])
            a.q, a.t = q, t
            a.vel_q, a.vel_t = None, None
            a.dev_chain = None  # host pose replaced — re-seed the chain
            a.ref_kf = cand
            a.last_feat_mp = feat_mp
            a.frames_lost = 0
            if new_map != old_map:
                a.map_id = new_map  # cross-map re-entry (reference :3491)
            self.events.append(
                f"RELOC agent={a.agent_id} kf={cand} map {old_map} -> "
                f"{new_map}")
            return True
        return False

    # ------------------------------------------------------------------
    def _create_map_in_atlas(self, a: AgentState):
        """Tracking::CreateMapInAtlas (:2589): the agent abandons tracking
        in its current map and starts a fresh map; the old map stays in the
        atlas and remains mergeable by the server."""
        a.map_id = self._alloc_map_id()
        a.state = NOT_INITIALIZED
        a.init_frame = None
        a.q = None
        a.t = None
        a.vel_q, a.vel_t = None, None
        a.dev_chain = None
        a.ref_kf = -1
        a.frames_lost = 0
        self.events.append(
            f"NEWMAP agent={a.agent_id} map={a.map_id}")

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, a: AgentState, n_in: int) -> bool:
        """Reference NeedNewKeyFrame (:2962) reduced to its mono core:
        interval bounds + tracked-vs-reference ratio, plus the MAM3SLAM
        refused-insertion condition c1d (``mnKFinsertionsRefusedSinceLast
        > 5`` forces the next insertion, src/Tracking.cc:3024) — under
        async mapping a busy worker refuses insertions and must not starve
        KF creation indefinitely."""
        cfg = self.cfg
        if a.state != OK:
            return False
        ref = max(a.ref_kf_tracked, 1)
        weak = n_in < cfg.kf_ref_ratio * ref
        c1 = a.frames_since_kf >= cfg.kf_max_interval
        c2 = a.frames_since_kf >= cfg.kf_min_interval and weak
        c1d = a.kf_insertions_refused > 5 and weak
        return (c1 or c2 or c1d) and n_in > 15

    def _kf_capacity_check(self, need: int = 1):
        """Loud failure before the jit scatter would silently clobber slot
        0 (add_keyframe recycles culled slots; full means truly full)."""
        n_live = int(np.asarray(self.ms.kf_valid).sum())
        if n_live + need > self.cfg.max_kf:
            raise MapCapacityError(
                f"keyframe arena exhausted: {n_live} live + {need} needed "
                f"> max_kf={self.cfg.max_kf} (raise SlamConfig.max_kf)")

    def _create_keyframe(self, a: AgentState, frame, feat_mp, inlier, ts,
                         snap_epoch=None):
        cfg = self.cfg
        self._kf_capacity_check(1)
        feat_mp_in = jnp.where(inlier, feat_mp, S.NO_MP)

        if self.async_mapping:
            # insert only when the back end has no MAPPING work pending
            # AND the frame's map snapshot is still structurally current
            # (feat_mp indexes MP slots of that snapshot); otherwise
            # refuse — the reference's SetAcceptKeyFrames(false)
            # back-pressure, counted per agent
            # (mnKFinsertionsRefusedSinceLast).  Stats-delta jobs hold
            # the lock only microseconds, so we WAIT for those instead
            # of refusing (refusing on them starved KF creation).
            if self._pending_mapping > 0 or self._jobs.full():
                a.kf_insertions_refused += 1
                return
            self._ms_lock.acquire()
            try:
                if (snap_epoch is not None
                        and snap_epoch != self.ms_epoch):
                    a.kf_insertions_refused += 1
                    return
                ms, kf = self.fns["add_kf_step"](
                    self.ms, frame, a.q, a.t, feat_mp_in, a.agent_id,
                    a.map_id, ts, a.next_agent_kf_id, a.cam.params)
                kf = int(kf)
                self.ms = ms
            finally:
                self._ms_lock.release()
            a.next_agent_kf_id += 1
            a.frames_since_kf = 0
            a.kf_insertions_refused = 0
            a.ref_kf = kf
            # the new KF's pose IS this frame's pose -> rel = identity
            a.last_rel = (np.array([1, 0, 0, 0], np.float32),
                          np.zeros(3, np.float32), kf)
            a.ref_kf_tracked = int((np.asarray(feat_mp_in) >= 0).sum())
            self._pending_mapping += 1
            self._jobs.put(("mapping", a.agent_id, kf))
            return

        if (self.pipeline and snap_epoch is not None
                and snap_epoch != self.ms_epoch):
            # this (deferred) frame's feat_mp indexes a structurally
            # stale snapshot — refuse, like the async back-pressure
            a.kf_insertions_refused += 1
            return
        ms, kf = self.fns["add_kf_step"](
            self.ms, frame, a.q, a.t, feat_mp_in, a.agent_id, a.map_id, ts,
            a.next_agent_kf_id, a.cam.params)
        kf = int(kf)
        self.ms = ms
        a.next_agent_kf_id += 1
        a.frames_since_kf = 0
        a.ref_kf = kf
        a.last_rel = (np.array([1, 0, 0, 0], np.float32),
                      np.zeros(3, np.float32), kf)
        a.ref_kf_tracked = int((np.asarray(feat_mp_in) >= 0).sum())
        self._local_mapping(a, kf)
        self.ms_epoch += 1
        if self.server is not None:
            self.server.process_keyframe(a.agent_id, kf)
            self.ms_epoch += 1

    def _run_mapping_epoch(self, kf, map_id):
        """Dispatch the fused mapping epoch for keyframe ``kf``."""
        return self.fns["mapping_epoch"](self.ms, jnp.asarray(kf),
                                         jnp.asarray(map_id),
                                         self._protected_refs())

    def _protected_refs(self):
        """KF slots the culling pass must never remove: every agent's
        current reference KF (reference SetNotErase/ref pinning)."""
        return jnp.asarray([a.ref_kf for a in self.agents]
                           + [-1], jnp.int32)

    # ------------------------------------------------------------------
    def _local_mapping(self, a: AgentState, kf: int):
        """LocalMapping::Run body for one keyframe (reference §3.3) —
        one fused device program (``mapping_epoch``), whose output
        includes the packed KeyFrameCulling decision, plus the host-side
        cull loop.  Host<->device traffic for the no-cull common case:
        the epoch dispatch + TWO fetches (n_drop and the [10, 12] pack);
        each actual removal adds one remove_kf dispatch + one re-scoring
        pack (erasures lower neighbors' redundancy — re-scoring on stale
        stats over-culls and starves small maps below the server's
        min_kfs_in_map gate)."""
        import time as _time
        _t0 = _time.perf_counter()
        ms, packed = self._run_mapping_epoch(kf, a.map_id)
        pk_all = np.asarray(packed)     # the epoch's ONE fetch
        n_drop = int(pk_all[0, 2])
        if n_drop:
            if self.mp_dropped == 0:
                self.events.append(
                    f"MP_ARENA_FULL agent={a.agent_id} dropping "
                    f"triangulations (raise SlamConfig.max_mp)")
            self.mp_dropped += n_drop

        # keyframe culling (reference KeyFrameCulling: >=90% of tracked
        # points redundant in >=3 other KFs at same/finer scale; bail
        # after a couple per pass).  All protection / redundancy /
        # parent-relative data arrives in the pack.
        pk = pk_all[1:]
        culled = 0
        while culled < 2:
            cand_j = -1
            for j in range(pk.shape[0]):
                if (pk[j, 1] > 0.5 and pk[j, 2] >= 0.9
                        and int(pk[j, 3]) > 20):
                    cand_j = j
                    break
            if cand_j < 0:
                break
            cand = int(pk[cand_j, 0])
            parent = int(pk[cand_j, 4])
            if parent >= 0:
                q_cp = pk[cand_j, 5:9].astype(np.float32)
                t_cp = pk[cand_j, 9:12].astype(np.float32)
                self.culled_kf[cand] = (parent, q_cp, t_cp)
                # EAGERLY re-reference trajectory rows onto the parent:
                # the culled slot recycles, so a later KF in the same
                # slot would otherwise hijack lazy resolve_ref walks
                for ag in self.agents:
                    for i in range(len(ag.trajectory)):
                        row = ag.trajectory[i]
                        if row[1] == cand:
                            q_n, t_n = _se3_compose_np(
                                row[2], row[3], q_cp, t_cp)
                            ag.trajectory[i] = (row[0], parent,
                                                q_n, t_n, row[4])
            ms = self.fns["remove_kf"](ms, jnp.asarray(cand))
            culled += 1
            if culled < 2:  # re-score on the post-removal state
                pk = np.asarray(self.fns["cull_pack"](
                    ms, jnp.asarray(kf), self._protected_refs()))
        self.ms = ms
        self.timers.add(f"LM_{a.agent_id}",
                        (_time.perf_counter() - _t0) * 1e3)

    # ------------------------------------------------------------------
    def _record_trajectory(self, a: AgentState, ts):
        """Store pose relative to the reference KF (reference
        Tracking :2189-2221) so later map corrections propagate for free.
        The fused tracking step already computed the relative pose
        (``a.last_rel``); other paths fetch the ref pose and compose in
        numpy (rare frames only)."""
        ref = a.ref_kf
        if a.last_rel is not None:
            q_rel, t_rel, ref = a.last_rel
        else:
            rq = np.asarray(self.ms.kf_q[ref], np.float32)
            rt = np.asarray(self.ms.kf_t[ref], np.float32)
            irq, irt = _se3_inverse_np(rq, rt)
            q_rel, t_rel = _se3_compose_np(
                np.asarray(a.q, np.float32), np.asarray(a.t, np.float32),
                irq, irt)
        a.trajectory.append((ts, ref, np.asarray(q_rel),
                             np.asarray(t_rel), a.state))

    def resolve_ref(self, ref, q_rel, t_rel):
        """Walk culled ancestors until a live reference KF is found
        (reference spanning-tree walk in SaveTrajectory)."""
        T_rel = lie.SE3(jnp.asarray(q_rel), jnp.asarray(t_rel))
        kf_valid = np.asarray(self.ms.kf_valid)
        seen = 0
        while ref >= 0 and not kf_valid[ref] and seen < 64:
            ent = self.culled_kf.get(ref)
            if ent is None:
                break
            parent, q_cp, t_cp = ent
            T_rel = lie.se3_compose(T_rel, lie.SE3(jnp.asarray(q_cp),
                                                   jnp.asarray(t_cp)))
            ref = parent
            seen += 1
        return ref, T_rel

    def trajectory_world(self, agent_id: int):
        """Reconstruct camera-to-world trajectory (TUM convention: Twc)."""
        a = self.agents[agent_id]
        out = []
        kf_q = np.asarray(self.ms.kf_q)
        kf_t = np.asarray(self.ms.kf_t)
        for ts, ref, q_rel, t_rel, state in a.trajectory:
            ref2, T_rel = self.resolve_ref(ref, q_rel, t_rel)
            T_ref = lie.SE3(jnp.asarray(kf_q[ref2]), jnp.asarray(kf_t[ref2]))
            T_cw = lie.se3_compose(T_rel, T_ref)
            T_wc = lie.se3_inverse(T_cw)
            out.append((ts, np.asarray(T_wc.q), np.asarray(T_wc.t), state))
        return out

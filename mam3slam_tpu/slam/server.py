"""Centralized loop-closing / map-merging server.

JAX-native equivalent of the reference's single LoopClosing thread
(``src/LoopClosing.cc``, SURVEY.md §2.2 + §3.4) — the multi-agent heart:
one server consumes keyframes from ALL agents, detects common regions
across all maps via BoW, verifies them geometrically with Sim3, and
executes intra-map loop corrections or inter-map (inter-agent) merges.

Reference semantics preserved:
* per-agent hypothesis state with 3-consecutive-KF confirmation and
  2-miss expiry (NewDetectCommonRegionsMulti :502-720);
* candidate thresholds nBoWMatches=20, nSim3Inliers=10(RANSAC),
  nProjOptMatches>=20 after guided projection + OptimizeSim3 (:893-897 —
  we use the post-optimization gate as the decisive one);
* loop: Sim3 propagation over the covisible window, map-point fusion,
  essential-graph PGO (CorrectLoop :1549);
* merge: Sim3-transform the current (newer) map into the matched (older)
  map, relabel, retarget every agent of the absorbed map, welding local BA
  (MergeLocalMulti :2277);
* maps with < 12 keyframes are skipped (:523).

The stop-the-world sections of the reference become synchronous epochs
here: the server mutates the shared functional MapState between tracking
steps (SURVEY.md §2.6).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mam3slam_tpu.geometry import cameras as cam_mod
from mam3slam_tpu.geometry import lie
from mam3slam_tpu.mapstate import state as S
from mam3slam_tpu.ops import bow
from mam3slam_tpu.ops import matching as M
from mam3slam_tpu.solvers import ba as ba_mod
from mam3slam_tpu.solvers import pgo as pgo_mod
from mam3slam_tpu.solvers import sim3 as sim3_mod
from mam3slam_tpu.slam import steps
from mam3slam_tpu.utils.timing import Timers


@dataclass
class Hypothesis:
    """Per-agent loop/merge hypothesis (reference Agent.h:221-240 fields)."""

    target_kf: int = -1
    is_merge: bool = False
    n_coincidences: int = 0
    n_misses: int = 0
    # S_cw mapping target-map world -> current KF camera
    q: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    s: float = 1.0
    last_kf: int = -1  # KF whose camera frame (q, t, s) refers to


@dataclass
class ServerConfig:
    min_kfs_in_map: int = 12
    n_candidates: int = 3
    n_bow_matches: int = 20
    n_sim3_inliers: int = 10
    n_proj_matches: int = 15
    n_proj_opt_matches: int = 20
    n_confirm: int = 3
    max_misses: int = 2
    pgo_min_covis_weight: int = 100
    vocab_k: int = 10
    vocab_depth: int = 3
    # hypothesis-refinement gates (reference DetectAndReffineSim3FromLastKF
    # LoopClosing.cc:726-728: nProjMatches=30, nProjOptMatches=50,
    # nProjMatchesRep=100).  None derives the reference ratios from the
    # detection thresholds (2x / 2.5x / 5x — exact at the defaults).
    n_refine_proj: Optional[int] = None
    n_refine_opt: Optional[int] = None
    n_refine_rep: Optional[int] = None
    # run the conditional post-loop/post-merge global BA as a background
    # device program (reference GBA thread, LoopClosing.cc:3579) instead
    # of a synchronous epoch; reconciled with spanning-tree catch-up when
    # it completes (slam/background_gba.py)
    async_gba: bool = False
    max_kf_for_gba: int = 200
    # run the conditional GBA as a DISTRIBUTED epoch over this
    # jax.sharding.Mesh (parallel/dist_window_ba.dist_global_ba) —
    # the multi-host production form; None = single-chip epoch
    gba_mesh: Optional[object] = None


@jax.jit
def _batched_rel(q, t, ei, ej):
    """Relative SE3-as-Sim3 measurements S_j * S_i^-1 (s=1) for an edge
    index batch — one fused dispatch replacing per-edge host composes."""
    qi, ti = q[ei], t[ei]
    qj, tj = q[ej], t[ej]
    qrel = lie.quat_normalize(lie.quat_mul(qj, lie.quat_conj(qi)))
    trel = tj - lie.quat_rotate(qrel, ti)
    return qrel, trel


class LoopServer:
    """Consumes (agent, kf) events; owns BoW database + hypothesis state."""

    def __init__(self, system, cfg: ServerConfig = None,
                 vocab: bow.Vocabulary = None, seed: int = 0,
                 gba_device=None):
        self.sys = system
        self.cfg = cfg or ServerConfig()
        self.voc = vocab
        self.gba = None           # BackgroundGBA, lazily created
        self.gba_device = gba_device
        self.hyp: Dict[int, Hypothesis] = {}
        self.key = jax.random.PRNGKey(seed + 1234)
        K = system.cfg.max_kf
        # sparse BoW database rows: a KF touches <= F words regardless of
        # vocabulary size, so [K, F] (ids, tf-idf) scales to the
        # reference's ~1M-leaf ORBvoc where a dense [K, W] matrix cannot
        self.kf_bow_words = None   # [K, F] i32 (-1 pad), lazily allocated
        self.kf_bow_vals = None    # [K, F] f32
        self._pending_index: List[int] = []  # KFs awaiting vocab training
        self.events: List[str] = []
        self.gba_runs: List[int] = []  # map ids GBA actually ran on
        self.timers = Timers()  # PR / LC / MM phase series (SURVEY §5)
        self._fns = {}

    # ------------------------------------------------------------------
    def ensure_vocab(self):
        """Train the vocabulary from descriptors already in the map if none
        was provided (bootstrap path; production runs pass a pre-trained
        one or import the reference's ORBvoc.txt via
        ``bow.load_orbvoc_text``)."""
        if self.voc is None:
            ms = self.sys.ms
            desc = np.asarray(ms.kf_feat_desc)
            valid = (np.asarray(ms.kf_feat_valid)
                     & np.asarray(ms.kf_valid)[:, None])
            sample = desc[valid][:120000]
            if len(sample) < 500:
                sample = np.random.default_rng(0).integers(
                    0, 256, (2000, 32), dtype=np.uint8)
            self.voc = bow.build_vocabulary(sample, k=self.cfg.vocab_k,
                                            depth=self.cfg.vocab_depth)
        if self.kf_bow_words is None:
            K = self.sys.cfg.max_kf
            F = self.sys.cfg.n_feat
            self.kf_bow_words = np.full((K, F), -1, np.int32)
            self.kf_bow_vals = np.zeros((K, F), np.float32)

    # ------------------------------------------------------------------
    def _index_keyframe(self, kf: int):
        """Quantize + store the KF's sparse BoW row
        (KeyFrameDatabase::add)."""
        ms = self.sys.ms
        desc = ms.kf_feat_desc[kf]
        valid = ms.kf_feat_valid[kf]
        bits = M.unpack_desc(desc)
        words = bow.quantize(self.voc, bits)
        # ONE packed fetch (each separate np.asarray is a full
        # device->host roundtrip)
        wv = np.asarray(jnp.stack([jnp.asarray(words, jnp.int32),
                                   valid.astype(jnp.int32)]))
        uw, vals = bow.sparse_bow_row(
            self.voc, wv[0], wv[1].astype(bool),
            self.kf_bow_words.shape[1])
        self.kf_bow_words[kf] = uw
        self.kf_bow_vals[kf] = vals

    # ------------------------------------------------------------------
    def process_keyframe(self, agent_id: int, kf: int):
        """LoopClosing::Run body for one popped keyframe."""
        with self.timers.measure("PR"):
            return self._process_keyframe(agent_id, kf)

    def _process_keyframe(self, agent_id: int, kf: int):
        ms = self.sys.ms
        if self.voc is None:
            # defer bootstrap vocabulary training until the atlas holds
            # enough descriptors to cluster meaningfully (detection is
            # gated at min_kfs_in_map KFs anyway); a vocab trained on the
            # first 2 KFs ranks candidates near-randomly on real images
            self._pending_index.append(kf)
            n_valid = int(np.asarray(ms.kf_valid).sum())
            if n_valid < self.cfg.min_kfs_in_map:
                return None
        self.ensure_vocab()
        if self._pending_index:
            kf_valid = np.asarray(self.sys.ms.kf_valid)
            for p in self._pending_index:
                if kf_valid[p]:  # culled slots skipped / recycled later
                    self._index_keyframe(p)
            self._pending_index = []
        else:
            self._index_keyframe(kf)
        # harvest a completed background GBA between epochs (reference
        # polls mbFinishedGBA in LoopClosing::Run)
        if self.gba is not None and self.gba.running and self.gba.ready:
            if self.gba.finish():
                self.events.append("GBA applied")
        ms = self.sys.ms
        hdr = np.asarray(jnp.stack([
            ms.kf_map[kf],
            jnp.sum((ms.kf_valid
                     & (ms.kf_map == ms.kf_map[kf])).astype(jnp.int32)),
        ]))
        kf_map = int(hdr[0])
        n_in_map = int(hdr[1])
        if n_in_map < self.cfg.min_kfs_in_map:
            return None

        # 1. continue an existing hypothesis for this agent
        h = self.hyp.get(agent_id)
        if h is not None and h.n_coincidences > 0:
            if self._refine_hypothesis(agent_id, kf, h):
                h.n_coincidences += 1
                h.n_misses = 0
                if h.n_coincidences >= self.cfg.n_confirm:
                    return self._trigger(agent_id, kf, h)
                return None
            h.n_misses += 1
            if h.n_misses > self.cfg.max_misses:
                del self.hyp[agent_id]

        # 2. fresh candidates from the BoW database
        loop_c, merge_c = self._detect_candidates(kf)
        for cand, is_merge in ([(c, False) for c in loop_c]
                               + [(c, True) for c in merge_c]):
            res = self._verify_candidate(kf, cand)
            if res is None:
                continue
            q, t, s = res
            self.hyp[agent_id] = Hypothesis(
                target_kf=cand, is_merge=is_merge, n_coincidences=1,
                q=q, t=t, s=s, last_kf=kf)
            break
        return None

    # ------------------------------------------------------------------
    def _detect_candidates(self, kf: int):
        """Covisibility-group accumulated scoring (the reference's
        DetectNBestCandidates, src/KeyFrameDatabase.cc:604-730): groups
        of covisible keyframes accumulate their members' BoW scores, each
        group is represented by its best member, and representatives are
        split into loop (same map) / merge (other map) candidates.  An
        isolated single-KF hit on repetitive texture no longer outranks a
        consistently-recognized region."""
        ms = self.sys.ms
        cfg = self.cfg
        q_dense = jnp.asarray(bow.dense_query(
            self.voc, self.kf_bow_words[kf], self.kf_bow_vals[kf]))
        db_words = jnp.asarray(self.kf_bow_words)
        scores = bow.l1_scores_sparse(q_dense, db_words,
                                      jnp.asarray(self.kf_bow_vals))
        shared = bow.shared_words_sparse(q_dense, db_words)
        K = ms.kf_valid.shape[0]
        eligible_dev = (ms.kf_valid & (ms.covis[kf] == 0)
                        & (jnp.arange(K) != kf))
        reps, acc, ok = bow.detect_candidates_grouped(
            scores, shared, eligible_dev, ms.covis,
            n_out=3 * cfg.n_candidates)
        # ONE packed fetch: per-arena rows + the grouped candidates
        pk = np.asarray(jnp.concatenate([
            ms.kf_valid.astype(jnp.int32),
            (ms.kf_map == ms.kf_map[kf]).astype(jnp.int32),
            jnp.asarray(reps, jnp.int32),
            jnp.asarray(ok, jnp.int32)]))
        kf_valid = pk[:K].astype(bool)
        same_map = pk[K:2 * K].astype(bool)
        reps_np = pk[2 * K:2 * K + reps.shape[0]]
        ok_np = pk[2 * K + reps.shape[0]:].astype(bool)
        loop_c, merge_c, seen = [], [], set()
        for r, o in zip(reps_np, ok_np):
            if not o:
                break
            r = int(r)
            if r in seen or not kf_valid[r] or r == kf:
                continue
            seen.add(r)
            if same_map[r] and len(loop_c) < cfg.n_candidates:
                loop_c.append(r)
            elif not same_map[r] and len(merge_c) < cfg.n_candidates:
                merge_c.append(r)
        return loop_c, merge_c

    # ------------------------------------------------------------------
    def _candidate_window_points(self, cand: int, n_covis: int = 5):
        """Map points observed by the candidate KF + its top covisibles
        (the reference matches against cand + 10 covisibles)."""
        ms = self.sys.ms
        idx, w, ok = S.best_covisible(ms, jnp.asarray(cand), n_covis)
        kf_sel = np.zeros(ms.kf_valid.shape[0], bool)
        kf_sel[cand] = True
        for i, o in zip(np.asarray(idx), np.asarray(ok)):
            if o:
                kf_sel[int(i)] = True
        fmp = np.asarray(ms.kf_feat_mp)
        mp_mask = np.zeros(ms.mp_valid.shape[0], bool)
        sel_mps = fmp[kf_sel]
        mp_mask[sel_mps[sel_mps >= 0]] = True
        return jnp.asarray(mp_mask & np.asarray(ms.mp_valid))

    # ------------------------------------------------------------------
    def _project_match_sim3(self, kf: int, Scw: "lie.Sim3", mp_mask,
                            th: float):
        """Guided Sim3 projection search into keyframe ``kf`` with the
        reference's full gate set (SearchByProjection(KF, Scw, ...),
        src/ORBmatcher.cc:534): depth > 0, in-image, scale-invariance
        distance bounds, viewing angle < 60 deg, predicted-level radius
        AND level-window gating.  Distances are measured in the candidate
        map's own world frame (camera center through Scw^-1), so the
        Sim3 scale cancels exactly as in the reference."""
        ms = self.sys.ms
        kind = self.sys.cfg.cam_kind
        cam = cam_mod.Camera(ms.kf_cam[kf], kind)
        sf = jnp.asarray(self.sys.cfg.scale_factors)
        proj = lie.sim3_apply(Scw, ms.mp_pos)
        uvp = cam_mod.project_ideal(cam, proj)
        in_img = ((uvp[:, 0] >= 0) & (uvp[:, 0] < self.sys.cfg.width)
                  & (uvp[:, 1] >= 0) & (uvp[:, 1] < self.sys.cfg.height))
        Ow = lie.sim3_apply(lie.sim3_inverse(Scw), jnp.zeros((3,)))
        vec = ms.mp_pos - Ow[None, :]
        dist = jnp.linalg.norm(vec, axis=-1)
        dist_ok = ((dist >= 0.8 * ms.mp_min_dist)
                   & (dist <= 1.2 * ms.mp_max_dist))
        view_cos = (jnp.sum(vec * ms.mp_normal, axis=-1)
                    / jnp.maximum(dist, 1e-9))
        n_levels = sf.shape[0]
        ratio = ms.mp_max_dist / jnp.maximum(dist, 1e-9)
        lvl = jnp.clip(jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9))
                                / jnp.log(sf[1])).astype(jnp.int32),
                       0, n_levels - 1)
        vis = (mp_mask & (proj[:, 2] > 0.05) & in_img & dist_ok
               & (view_cos > 0.5))
        mres = M.search_by_projection_frame(
            uvp, lvl, th * sf[lvl], M.unpack_desc(ms.mp_desc), vis,
            ms.kf_feat_uv[kf], ms.kf_feat_level[kf],
            M.unpack_desc(ms.kf_feat_desc[kf]), ms.kf_feat_valid[kf],
            level_lo=1, level_hi=1)
        return mres, int(np.asarray(mres.ok).sum())

    def _optimize_sim3_pairs(self, kf: int, cand: int, mres, S12_init):
        """OptimizeSim3 on GENUINE matched pairs (reference
        Optimizer::OptimizeSim3 src/Optimizer.cc:2115: edges only where
        the current KF's matched feature carries its OWN map point and
        the candidate point is observed in the candidate KF — both
        reprojection directions are then independent constraints)."""
        ms = self.sys.ms
        kind = self.sys.cfg.cam_kind
        cam_kf = cam_mod.Camera(ms.kf_cam[kf], kind)
        cam_cand = cam_mod.Camera(ms.kf_cam[cand], kind)
        s2 = self.sys.cfg.sigma2
        T2 = lie.sim3_from_se3(lie.SE3(ms.kf_q[cand], ms.kf_t[cand]))
        pc2 = lie.sim3_apply(T2, ms.mp_pos)       # candidate-camera frame
        f1 = jnp.clip(mres.idx, 0)                # matched feature in kf
        uv1 = ms.kf_feat_uv[kf][f1]
        mp1 = ms.kf_feat_mp[kf][f1]               # current map's own MP
        has1 = mp1 >= 0
        p1w = ms.mp_pos[jnp.clip(mp1, 0)]
        pc1 = lie.quat_rotate(ms.kf_q[kf][None], p1w) + ms.kf_t[kf][None]
        hit2 = ms.mp_obs_kf == cand               # [P, M]
        has2 = hit2.any(-1)
        f2 = jnp.clip(ms.mp_obs_feat[
            jnp.arange(hit2.shape[0]), jnp.argmax(hit2, axis=-1)], 0)
        uv2 = ms.kf_feat_uv[cand][f2]
        pair_ok = mres.ok & has1 & has2
        lvl_f1 = ms.kf_feat_level[kf][f1]
        lvl_f2 = ms.kf_feat_level[cand][f2]
        sg1 = jnp.asarray(s2)[jnp.clip(lvl_f1, 0, len(s2) - 1)]
        sg2 = jnp.asarray(s2)[jnp.clip(lvl_f2, 0, len(s2) - 1)]
        return sim3_mod.optimize_sim3(
            S12_init.q, S12_init.t, S12_init.s, pc1, pc2, uv1, uv2,
            pair_ok, cam_kf, cam_cand, sg1, sg2), T2

    def _verify_candidate(self, kf: int, cand: int):
        """BoW match -> Sim3 RANSAC -> guided projection + OptimizeSim3.

        Returns (q, t, s) of S_cw: candidate-map WORLD -> current KF camera
        (the reference's mg2oLoopScw), or None.
        """
        ms = self.sys.ms
        cfg = self.cfg
        kind = self.sys.cfg.cam_kind
        cam_kf = cam_mod.Camera(ms.kf_cam[kf], kind)
        cam_cand = cam_mod.Camera(ms.kf_cam[cand], kind)

        # BoW-space brute force between the two KFs' features (with mp)
        bits1 = M.unpack_desc(ms.kf_feat_desc[kf])
        bits2 = M.unpack_desc(ms.kf_feat_desc[cand])
        has1 = ms.kf_feat_valid[kf] & (ms.kf_feat_mp[kf] >= 0)
        has2 = ms.kf_feat_valid[cand] & (ms.kf_feat_mp[cand] >= 0)
        res = M.search_by_brute_force(
            bits1, has1, ms.kf_feat_angle[kf],
            bits2, has2, ms.kf_feat_angle[cand])
        n_bow = int(np.asarray(res.ok).sum())
        # per-stage funnel counters (reference's bDoWrite debug dumps,
        # LoopClosing.cc:1016-1066) — cheap, invaluable on real data
        self.last_verify = {"kf": kf, "cand": cand, "n_bow": n_bow,
                            "n_ransac": 0, "n_proj": 0, "n_opt_inl": 0,
                            "n_final": 0}
        if n_bow < cfg.n_bow_matches:
            return None

        mp1 = np.asarray(ms.kf_feat_mp[kf])
        mp2 = np.asarray(ms.kf_feat_mp[cand])
        idx = np.asarray(res.idx)
        okm = np.asarray(res.ok)
        F = len(mp1)
        pts1 = ms.mp_pos[jnp.asarray(np.maximum(mp1, 0))]
        pts2 = ms.mp_pos[jnp.asarray(np.maximum(mp2[idx], 0))]
        uv1 = ms.kf_feat_uv[kf]
        uv2 = ms.kf_feat_uv[cand][jnp.asarray(idx)]
        lvl1 = np.asarray(ms.kf_feat_level[kf])
        lvl2 = np.asarray(ms.kf_feat_level[cand])[idx]
        s2 = self.sys.cfg.sigma2
        sig1 = jnp.asarray(s2[np.clip(lvl1, 0, len(s2) - 1)])
        sig2 = jnp.asarray(s2[np.clip(lvl2, 0, len(s2) - 1)])

        self.key, sub = jax.random.split(self.key)
        r = sim3_mod.ransac_sim3(
            pts1, pts2, jnp.asarray(okm),
            uv1, uv2, cam_kf, cam_cand,
            ms.kf_q[kf], ms.kf_t[kf], ms.kf_q[cand], ms.kf_t[cand],
            sub, sig1, sig2, min_inliers=cfg.n_sim3_inliers)
        self.last_verify["n_ransac"] = int(np.asarray(r.n_inliers)) \
            if hasattr(r, "n_inliers") else int(bool(r.ok))
        if not bool(r.ok):
            return None

        # guided projection of the candidate window's map points into the
        # current KF using the Sim3 (SearchByProjection th=8, full gate
        # set incl. predicted-level window), then refine
        mp_mask = self._candidate_window_points(cand)
        # S_c1<-w2 = S_c1<-c2 * T_c2<-w2
        S12 = lie.Sim3(r.q, r.t, r.s)
        T2 = lie.sim3_from_se3(lie.SE3(ms.kf_q[cand], ms.kf_t[cand]))
        Scw = lie.sim3_compose(S12, T2)
        mres, n_proj = self._project_match_sim3(kf, Scw, mp_mask, th=8.0)
        self.last_verify["n_proj"] = n_proj
        if n_proj < cfg.n_proj_matches:
            return None

        # refine with optimize_sim3 on genuine matched pairs
        (q_o, t_o, s_o, inl, n_in), _ = self._optimize_sim3_pairs(
            kf, cand, mres, S12)
        self.last_verify["n_opt_inl"] = int(n_in)
        if int(n_in) < cfg.n_sim3_inliers:
            return None

        # decisive gate: re-project the window through the OPTIMIZED Sim3
        # at the narrow radius (reference SearchByProjection th=5 then
        # numProjOptMatches >= nProjOptMatches, LoopClosing.cc:1310-1350)
        Scw_o = lie.sim3_compose(lie.Sim3(q_o, t_o, s_o), T2)
        mres_o, n_opt = self._project_match_sim3(kf, Scw_o, mp_mask,
                                                 th=5.0)
        self.last_verify["n_final"] = n_opt
        if n_opt < cfg.n_proj_opt_matches:
            return None

        return (np.asarray(Scw_o.q), np.asarray(Scw_o.t), float(Scw_o.s))

    # ------------------------------------------------------------------
    def _refine_hypothesis(self, agent_id: int, kf: int, h: Hypothesis):
        """DetectAndReffineSim3FromLastKF (reference LoopClosing.cc:720-
        880): propagate S_cw through the agent's motion, re-match by
        guided projection (full gate set), RE-OPTIMIZE the Sim3 on the
        fresh matches, and accept only if the re-projection through the
        optimized Sim3 still matches widely — the hypothesis is
        *corrected* every confirmation, not merely counted."""
        ms = self.sys.ms
        cfg = self.cfg
        # propagate through the agent's own relative motion since the
        # hypothesis' last KF: S_cur = T_cur * T_prev^-1 * S_prev
        prev_kf = h.last_kf
        S_prev = lie.Sim3(jnp.asarray(h.q), jnp.asarray(h.t),
                          jnp.asarray(h.s, jnp.float32))
        T_cur = lie.sim3_from_se3(lie.SE3(ms.kf_q[kf], ms.kf_t[kf]))
        T_prev = lie.sim3_from_se3(
            lie.SE3(ms.kf_q[prev_kf], ms.kf_t[prev_kf]))
        rel = lie.sim3_compose(T_cur, lie.sim3_inverse(T_prev))
        S_cur = lie.sim3_compose(rel, S_prev)

        # `is None` (not falsy-or): an explicitly configured 0 must
        # disable the gate, not silently re-derive the default
        n_proj_th = (cfg.n_refine_proj if cfg.n_refine_proj is not None
                     else 2 * cfg.n_proj_matches)
        n_opt_th = (cfg.n_refine_opt if cfg.n_refine_opt is not None
                    else int(2.5 * cfg.n_proj_opt_matches))
        n_rep_th = (cfg.n_refine_rep if cfg.n_refine_rep is not None
                    else 5 * cfg.n_proj_opt_matches)

        mp_mask = self._candidate_window_points(h.target_kf)
        mres, n1 = self._project_match_sim3(kf, S_cur, mp_mask, th=8.0)
        # the propagated pose is kept either way (next confirmation
        # propagates from this KF)
        h.q, h.t, h.s = (np.asarray(S_cur.q), np.asarray(S_cur.t),
                         float(S_cur.s))
        h.last_kf = kf
        if n1 < n_proj_th:
            return False

        # second OptimizeSim3 pass on the fresh matches
        T2 = lie.sim3_from_se3(lie.SE3(ms.kf_q[h.target_kf],
                                       ms.kf_t[h.target_kf]))
        S12_0 = lie.sim3_compose(S_cur, lie.sim3_inverse(T2))
        (q_o, t_o, s_o, inl, n_in), _ = self._optimize_sim3_pairs(
            kf, h.target_kf, mres, S12_0)
        if int(n_in) < n_opt_th:
            return False

        # decisive wide re-projection through the optimized Sim3
        Scw_o = lie.sim3_compose(lie.Sim3(q_o, t_o, s_o), T2)
        mres2, n2 = self._project_match_sim3(kf, Scw_o, mp_mask, th=5.0)
        if n2 < n_rep_th:
            return False
        h.q, h.t, h.s = (np.asarray(Scw_o.q), np.asarray(Scw_o.t),
                         float(Scw_o.s))
        return True

    # ------------------------------------------------------------------
    def _run_gba(self, map_id: int):
        """Conditional full-map BA: synchronous epoch by default, or a
        background device program when cfg.async_gba."""
        self.gba_runs.append(map_id)
        if self.cfg.gba_mesh is not None:
            from mam3slam_tpu.parallel import dist_window_ba as dwb
            self.sys.ms = dwb.dist_global_ba(
                self.sys.ms, self.sys.cfg, self.cfg.gba_mesh, map_id,
                self.sys.cfg.cam_kind)
            return
        if self.cfg.async_gba:
            if self.gba is None:
                from mam3slam_tpu.slam.background_gba import BackgroundGBA
                self.gba = BackgroundGBA(self.sys, device=self.gba_device)
            if not self.gba.running:
                self.gba.start(map_id)
        else:
            self.sys.ms = self.sys.fns["global_ba"](
                self.sys.ms, jnp.asarray(map_id))

    def flush_gba(self):
        """Block on and apply any pending background GBA (shutdown path).

        The write-back mutates sys.ms, so under async mapping it must hold
        the system's structural lock — flush_gba may be called while
        mapping jobs are still in flight."""
        if self.gba is not None and self.gba.running:
            import contextlib
            lock = (self.sys._ms_lock if getattr(
                self.sys, "async_mapping", False) else
                contextlib.nullcontext())
            with lock:
                if self.gba.finish():
                    self.events.append("GBA applied")

    def _trigger(self, agent_id: int, kf: int, h: Hypothesis):
        del self.hyp[agent_id]
        # a new loop/merge invalidates any in-flight GBA (reference aborts
        # via mbStopGBA, LoopClosing.cc:2300-2313)
        if self.gba is not None and self.gba.running:
            self.gba.abort()
            self.events.append("GBA aborted")
        if h.is_merge or int(self.sys.ms.kf_map[kf]) != int(
                self.sys.ms.kf_map[h.target_kf]):
            self.merge_maps(agent_id, kf, h)
            return "merge"
        self.correct_loop(agent_id, kf, h)
        return "loop"

    # ------------------------------------------------------------------
    def correct_loop(self, agent_id: int, kf: int, h: Hypothesis):
        """CorrectLoop: Sim3-correct the covisible window, fuse duplicate
        points, essential-graph PGO over the whole map."""
        import time as _time
        _t0 = _time.perf_counter()
        sysm = self.sys
        ms = sysm.ms
        cfg = self.cfg
        K = ms.kf_valid.shape[0]
        kf_map = int(ms.kf_map[kf])
        in_map = np.asarray(ms.kf_valid) & (np.asarray(ms.kf_map) == kf_map)

        # corrected pose of current KF from hypothesis: S_cw (scale s)
        S_corr = lie.Sim3(jnp.asarray(h.q), jnp.asarray(h.t),
                          jnp.asarray(h.s, jnp.float32))
        T_cur = lie.sim3_from_se3(lie.SE3(ms.kf_q[kf], ms.kf_t[kf]))

        # build Sim3 pose array: all KFs at their current SE3 (s=1);
        # the current KF window gets the corrected Sim3 propagated through
        # relative poses:  S_iw_corr = T_ic * S_corr
        q_all = np.asarray(ms.kf_q).copy()
        t_all = np.asarray(ms.kf_t).copy()
        s_all = np.ones(K, np.float32)

        idx, w, ok = S.best_covisible(ms, jnp.asarray(kf), 16)
        window = [kf] + [int(i) for i, o in zip(np.asarray(idx),
                                                np.asarray(ok)) if o]
        T_cur_inv = lie.sim3_inverse(T_cur)
        for k_i in window:
            T_i = lie.sim3_from_se3(lie.SE3(ms.kf_q[k_i], ms.kf_t[k_i]))
            T_ic = lie.sim3_compose(T_i, T_cur_inv)
            S_i = lie.sim3_compose(T_ic, S_corr)
            q_all[k_i] = np.asarray(S_i.q)
            t_all[k_i] = np.asarray(S_i.t)
            s_all[k_i] = float(S_i.s)

        # correct window map points through their ref-KF transform, then
        # run PGO over the essential graph
        edges = self._essential_edges(ms, kf, h.target_kf, S_corr, in_map)
        fixed = np.zeros(K, bool)
        fixed[h.target_kf] = True
        fixed[~in_map] = True

        q0 = jnp.asarray(q_all)
        t0 = jnp.asarray(t_all)
        s0 = jnp.asarray(s_all)
        # inertial maps: roll/pitch are observable from gravity and the
        # map is metric, so the essential graph optimizes only yaw +
        # translation with scale held at 1 (reference
        # Optimizer::OptimizeEssentialGraph4DoF, Optimizer.cc:5299, via
        # the inertial LoopClosing branch LoopClosing.cc:2918-2934 —
        # commented out there, wired here).  Gate mirrors
        # pMap->IsInertial() && pMap->GetIniertialBA2(): any agent whose
        # VI initialization belongs to this map.
        inertial_agent = next(
            (a for a in sysm.agents
             if a.imu_initialized and a.imu_init_map == kf_map), None)
        inertial = inertial_agent is not None
        if inertial:
            # yaw axis = map-frame UP (our maps are not re-rotated after
            # VI init; gravity lives in agent.gravity_w)
            g = inertial_agent.gravity_w
            axis = (None if g is None
                    else -np.asarray(g) / np.linalg.norm(g))
            q_n, t_n = pgo_mod.optimize_essential_graph_4dof(
                q0, t0, jnp.asarray(fixed), edges, iters=12,
                gravity_axis=axis)
            s_n = jnp.ones(K)
        else:
            q_n, t_n, s_n = pgo_mod.optimize_essential_graph(
                q0, t0, s0, jnp.asarray(fixed), edges, iters=12)

        # map points: correct through reference KF before/after
        mp_mask = jnp.asarray(np.asarray(ms.mp_valid)
                              & (np.asarray(ms.mp_map) == kf_map))
        new_pos = pgo_mod.correct_points_by_ref(
            ms.mp_pos, ms.mp_ref_kf, mp_mask,
            ms.kf_q, ms.kf_t, jnp.ones(K), q_n, t_n, s_n)

        # fold scale into SE3 poses: T_cw = (R, t/s)
        q_out = lie.quat_normalize(q_n)
        t_out = t_n / jnp.maximum(s_n[:, None], 1e-9)
        upd = jnp.asarray(in_map)
        ms = ms._replace(
            kf_q=jnp.where(upd[:, None], q_out, ms.kf_q),
            kf_t=jnp.where(upd[:, None], t_out, ms.kf_t),
            mp_pos=new_pos,
            map_change=ms.map_change.at[kf_map].add(1))
        # persist the closed loop (KeyFrame::AddLoopEdge) so every later
        # PGO keeps this constraint — a second loop closure must not
        # re-open the first
        ms = S.add_loop_edge(ms, h.target_kf, kf)
        sysm.ms = ms

        # fuse duplicated points in the loop region and refresh
        local_mask = sysm.fns["local_mp_mask"](ms, jnp.asarray(kf), 16)
        ms, _ = sysm.fns["fuse_step"](ms, jnp.asarray(kf), local_mask)
        ms = sysm.fns["refresh_stats"](ms, ms.mp_valid)
        sysm.ms = ms
        # conditional global BA (reference LoopClosing.cc:1766-1775:
        # map < 200 KFs AND the atlas holds a single map — a loop closed
        # while other maps exist must not spend a GBA the reference
        # would skip)
        if (int(np.asarray(in_map).sum()) < self.cfg.max_kf_for_gba
                and int(np.asarray(ms.map_valid).sum()) == 1):
            self._run_gba(kf_map)
        ms = sysm.ms
        self.events.append(
            f"LOOP agent={agent_id} kf={kf} target={h.target_kf} "
            f"map={kf_map}" + (" pgo=4dof" if inertial else ""))
        self.timers.add("LC", (_time.perf_counter() - _t0) * 1e3)

    # ------------------------------------------------------------------
    def _essential_edges(self, ms, kf, target_kf, S_corr, in_map):
        """Essential graph (reference Optimizer::OptimizeEssentialGraph
        :1501-1783 edge set): spanning tree + strong covisibility +
        HISTORICAL loop/merge edges (``ms.loop_*``) + the new loop edge.

        Measurements are relative Sim3s at the CURRENT (non-corrected)
        estimates — exactly the reference, which reads NonCorrectedSim3 /
        vScw for every stored edge; only the new loop edge carries the
        externally verified Sim3.  Edge *selection* is a few vectorized
        numpy scans and the measurement batch is ONE jitted composite
        (``_batched_rel``) — no O(K^2) host loop (round-1 weakness #4).
        """
        ei, ej, ew = self._essential_edge_set(ms, in_map,
                                              exclude_pair=(kf, target_kf))
        qrel, trel = _batched_rel(ms.kf_q, ms.kf_t, jnp.asarray(ei),
                                  jnp.asarray(ej))

        # new loop edge: measured S_cur,target = S_corr * T_target^-1
        T_t = lie.sim3_from_se3(lie.SE3(ms.kf_q[target_kf],
                                        ms.kf_t[target_kf]))
        m = lie.sim3_compose(lie.Sim3(
            jnp.asarray(S_corr.q), jnp.asarray(S_corr.t),
            jnp.asarray(S_corr.s)), lie.sim3_inverse(T_t))

        E = len(ei) + 1
        return pgo_mod.PGOEdges(
            i=jnp.asarray(np.append(ei, target_kf), jnp.int32),
            j=jnp.asarray(np.append(ej, kf), jnp.int32),
            q=jnp.concatenate([qrel, m.q[None]]).astype(jnp.float32),
            t=jnp.concatenate([trel, m.t[None]]).astype(jnp.float32),
            s=jnp.concatenate([jnp.ones(len(ei)), m.s[None]]).astype(
                jnp.float32),
            w=jnp.asarray(np.append(ew, 5.0), jnp.float32),
            valid=jnp.ones(E, bool))

    def _essential_edge_set(self, ms, in_map, exclude_pair=None):
        """Vectorized essential-graph edge selection: spanning tree +
        strong covisibility + historical loop/merge edges, as index/weight
        numpy arrays (measurements are batched separately by the caller).
        """
        parent = np.asarray(ms.kf_parent)
        valid = np.asarray(ms.kf_valid) & in_map

        # spanning-tree edges: (parent[j], j) where both in-map
        j_all = np.where(valid & (parent >= 0))[0]
        j_tree = j_all[valid[parent[j_all]]]
        i_tree = parent[j_tree]

        # strong covisibility edges, deduped to i < j, excluding tree pairs
        covis = np.asarray(ms.covis)
        cmask = (covis >= self.cfg.pgo_min_covis_weight) \
            & valid[:, None] & valid[None, :]
        iu, ju = np.nonzero(np.triu(cmask, k=1))
        keep = (parent[ju] != iu) & (parent[iu] != ju)
        i_cov, j_cov = iu[keep], ju[keep]

        # historical loop/merge edges with both endpoints in this map
        li = np.asarray(ms.loop_i)
        lj = np.asarray(ms.loop_j)
        lok = np.asarray(ms.loop_valid)
        lok = lok & valid[np.clip(li, 0, len(valid) - 1)] \
            & valid[np.clip(lj, 0, len(valid) - 1)]
        if exclude_pair is not None:
            # the caller appends a fresh measured edge for this pair —
            # drop the stored duplicate
            kf, target_kf = exclude_pair
            lok = lok & ~(((li == target_kf) & (lj == kf))
                          | ((li == kf) & (lj == target_kf)))
        i_loop, j_loop = li[lok], lj[lok]

        ei = np.concatenate([i_tree, i_cov, i_loop]).astype(np.int32)
        ej = np.concatenate([j_tree, j_cov, j_loop]).astype(np.int32)
        ew = np.ones(len(ei), np.float32)
        ew[len(i_tree) + len(i_cov):] = 5.0  # loop edges weighted up
        return ei, ej, ew

    # ------------------------------------------------------------------
    def merge_maps(self, agent_id: int, kf: int, h: Hypothesis):
        """MergeLocalMulti: transform the current KF's map into the target
        map's frame with the verified Sim3, relabel, retarget agents,
        welding BA around the seam."""
        import time as _time
        _t0 = _time.perf_counter()
        sysm = self.sys
        ms = sysm.ms
        cur_map = int(ms.kf_map[kf])
        tgt_map = int(ms.kf_map[h.target_kf])
        K = ms.kf_valid.shape[0]

        # S_cw maps target-map world -> current camera.  Current pose maps
        # current-map world -> current camera.  The transform taking
        # current-map world coords into target-map world coords:
        #   S_w2<-w1 = S_cw^-1 * T_cw1   (w2 = target world, w1 = cur world)
        S_cw = lie.Sim3(jnp.asarray(h.q), jnp.asarray(h.t),
                        jnp.asarray(h.s, jnp.float32))
        T_c_w1 = lie.sim3_from_se3(lie.SE3(ms.kf_q[kf], ms.kf_t[kf]))
        S_21 = lie.sim3_compose(lie.sim3_inverse(S_cw), T_c_w1)
        S_12 = lie.sim3_inverse(S_21)

        in_cur = jnp.asarray(np.asarray(ms.kf_valid)
                             & (np.asarray(ms.kf_map) == cur_map))
        mp_cur = jnp.asarray(np.asarray(ms.mp_valid)
                             & (np.asarray(ms.mp_map) == cur_map))

        # KF poses: T'_cw2 = T_cw1 * S_12  (fold scale into translation)
        T_all = lie.sim3_from_se3(lie.SE3(ms.kf_q, ms.kf_t))
        T_new = lie.sim3_compose(T_all, lie.Sim3(
            jnp.broadcast_to(S_12.q, (K, 4)),
            jnp.broadcast_to(S_12.t, (K, 3)),
            jnp.broadcast_to(S_12.s, (K,))))
        q_new = lie.quat_normalize(T_new.q)
        t_new = T_new.t / jnp.maximum(T_new.s[:, None], 1e-9)

        # MP positions: x2 = S_21(x1)
        mp_new = lie.sim3_apply(S_21, ms.mp_pos)

        ms = ms._replace(
            kf_q=jnp.where(in_cur[:, None], q_new, ms.kf_q),
            kf_t=jnp.where(in_cur[:, None], t_new, ms.kf_t),
            kf_map=jnp.where(in_cur, tgt_map, ms.kf_map),
            mp_pos=jnp.where(mp_cur[:, None], mp_new, ms.mp_pos),
            mp_map=jnp.where(mp_cur, tgt_map, ms.mp_map),
            map_valid=ms.map_valid.at[cur_map].set(False),
            map_change=ms.map_change.at[tgt_map].add(1),
        )
        # distance bounds scale by 1/s21? sim3_apply scales distances by s
        ms = ms._replace(
            mp_min_dist=jnp.where(mp_cur, ms.mp_min_dist * S_21.s,
                                  ms.mp_min_dist),
            mp_max_dist=jnp.where(mp_cur, ms.mp_max_dist * S_21.s,
                                  ms.mp_max_dist))
        sysm.ms = ms

        # invert the spanning-tree chain across the seam (reference
        # :2608-2624): the merging KF becomes a child of the matched KF,
        # and its old ancestor chain is reversed so the merged map has a
        # single connected tree rooted in the target map.
        parent = np.asarray(ms.kf_parent).copy()
        chain = [kf]
        p = int(parent[kf])
        seen = 0
        while p >= 0 and seen < parent.shape[0]:
            chain.append(p)
            p = int(parent[p])
            seen += 1
        for child, par in zip(chain[:-1], chain[1:]):
            parent[par] = child  # invert each edge along the chain
        parent[kf] = h.target_kf
        ms = ms._replace(kf_parent=jnp.asarray(parent))
        # persist the merge seam (KeyFrame::AddMergeEdge) for later PGOs
        ms = S.add_loop_edge(ms, h.target_kf, kf)
        sysm.ms = ms

        # retarget every agent of the absorbed map (reference :2595-2603)
        for a in sysm.agents:
            if a.map_id == cur_map:
                a.map_id = tgt_map
                if a.q is not None and a.agent_id == agent_id:
                    T_a = lie.sim3_from_se3(lie.SE3(a.q, a.t))
                    T_an = lie.sim3_compose(T_a, S_12)
                    a.q = lie.quat_normalize(T_an.q)
                    a.t = T_an.t / jnp.maximum(T_an.s, 1e-9)
                    a.dev_chain = None  # host pose diverged from chain

        # weld: fuse duplicate points around the seam, refresh, then the
        # merge-welding BA (adjust = absorbed-side window, fix =
        # merge-target side; reference src/Optimizer.cc:3505)
        local_mask = sysm.fns["local_mp_mask"](sysm.ms, jnp.asarray(
            h.target_kf), 16)
        ms2, _ = sysm.fns["fuse_step"](sysm.ms, jnp.asarray(kf),
                                       local_mask)
        sysm.ms = sysm.fns["refresh_stats"](ms2, ms2.mp_valid)
        in_cur_host = np.asarray(in_cur)
        q_pre, t_pre = sysm.ms.kf_q, sysm.ms.kf_t
        sysm.ms, weld_mask, weld_pts = sysm.fns["welding_ba"](
            sysm.ms, jnp.asarray(kf), jnp.asarray(in_cur_host))
        # merge PGO overload: propagate the weld through the absorbed
        # map's remainder (reference src/Optimizer.cc:1785)
        self._merge_pgo(in_cur_host, np.asarray(weld_mask),
                        np.asarray(weld_pts), q_pre, t_pre, tgt_map)
        # optional full-map BA after the weld (reference MergeLocalMulti
        # GBA :2838-2845), only while the merged map is small — the
        # welding BA + merge PGO already make the map consistent.
        n_in_tgt = int((np.asarray(sysm.ms.kf_valid)
                        & (np.asarray(sysm.ms.kf_map) == tgt_map)).sum())
        if n_in_tgt < self.cfg.max_kf_for_gba:
            self._run_gba(tgt_map)
        self.events.append(
            f"MERGE agent={agent_id} map {cur_map} -> {tgt_map} "
            f"kf={kf} target={h.target_kf} "
            f"ts={float(self.sys.ms.kf_ts[kf]):.6f}")
        self.timers.add("MM", (_time.perf_counter() - _t0) * 1e3)

    def _merge_pgo(self, in_cur, weld_mask, weld_pts, q_pre, t_pre,
                   tgt_map):
        """Merge overload of the essential-graph PGO (reference
        Optimizer::OptimizeEssentialGraph merge variant,
        src/Optimizer.cc:1785): after the welding BA has moved the seam
        window, distribute that adjustment through the absorbed map's
        REMAINDER.  Fixed = every original target-map KF plus the welded
        window (already locally optimal); free = the absorbed map's
        remaining KFs.  Edge measurements are relative Sim3s at the
        PRE-weld estimates (the reference's NonCorrectedSim3), so the
        residuals carry the window's motion out to the remainder.  This is
        what keeps a 500-KF merge cheap where a full GBA would not be."""
        sysm = self.sys
        ms = sysm.ms
        K = ms.kf_valid.shape[0]
        valid = np.asarray(ms.kf_valid)
        merged = valid & (np.asarray(ms.kf_map) == tgt_map)
        fixed = merged & (~in_cur | weld_mask)
        free = merged & ~fixed
        if not free.any() or not fixed.any():
            return
        ei, ej, ew = self._essential_edge_set(ms, merged)
        if len(ei) == 0:
            return
        qrel, trel = _batched_rel(q_pre, t_pre, jnp.asarray(ei),
                                  jnp.asarray(ej))
        edges = pgo_mod.PGOEdges(
            i=jnp.asarray(ei), j=jnp.asarray(ej),
            q=qrel.astype(jnp.float32), t=trel.astype(jnp.float32),
            s=jnp.ones(len(ei), jnp.float32), w=jnp.asarray(ew),
            valid=jnp.ones(len(ei), bool))
        fixed_j = jnp.asarray(fixed | ~merged)
        q_n, t_n, s_n = pgo_mod.optimize_essential_graph(
            ms.kf_q, ms.kf_t, jnp.ones(K), fixed_j, edges, iters=10)
        # correct remainder points through their (free) reference KFs;
        # points the welding BA already optimized (weld_pts — the
        # reference's spLocalWindowMPs moved before the remainder update,
        # LoopClosing.cc:2583,2695) are excluded even when their ref KF is
        # in the free remainder, else they would be displaced twice
        ref_free = free[np.clip(np.asarray(ms.mp_ref_kf), 0, K - 1)]
        mp_mask = jnp.asarray(np.asarray(ms.mp_valid)
                              & (np.asarray(ms.mp_map) == tgt_map)
                              & ref_free & ~np.asarray(weld_pts))
        new_pos = pgo_mod.correct_points_by_ref(
            ms.mp_pos, ms.mp_ref_kf, mp_mask,
            ms.kf_q, ms.kf_t, jnp.ones(K), q_n, t_n, s_n)
        upd = jnp.asarray(free)
        sysm.ms = ms._replace(
            kf_q=jnp.where(upd[:, None], lie.quat_normalize(q_n), ms.kf_q),
            kf_t=jnp.where(upd[:, None],
                           t_n / jnp.maximum(s_n[:, None], 1e-9), ms.kf_t),
            mp_pos=new_pos)
        # refresh normals / view-distance bounds of every point the weld or
        # the remainder transport moved (reference UpdateNormalAndDepth
        # after the remainder correction; recomputing from geometry also
        # absorbs the Sim3 scale s_n into the bounds)
        sysm.ms = sysm.fns["refresh_stats"](
            sysm.ms, jnp.asarray(mp_mask | jnp.asarray(weld_pts)))

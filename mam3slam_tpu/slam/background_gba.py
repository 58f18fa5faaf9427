"""Background (task-parallel) global bundle adjustment.

JAX-native re-expression of the reference's GBA thread
(``LoopClosing::RunGlobalBundleAdjustment``, src/LoopClosing.cc:3579-3831):
the reference spawns a std::thread that runs a 10-iteration g2o GBA
concurrently with tracking/mapping, abortable via ``mbStopGBA``, and on
completion stops all agents' local mappers and *catches up* — keyframes
created during the GBA get their corrected pose by propagating the parent's
before/after transform down the spanning tree (:3648-3721), and map points
not optimized by the GBA are corrected through their reference keyframe's
before/after transform (:3773-3800).

Here the "thread" is XLA's asynchronous dispatch: ``start`` snapshots the
functional MapState (free — arrays are immutable) and dispatches the GBA
device program, optionally onto a *different device* of the mesh so it
overlaps tracking on the primary chip.  The host polls ``ready`` between
tracking epochs; ``finish`` reconciles the GBA result into the *current*
state (which may have grown meanwhile) with exactly the reference's
catch-up semantics.  ``abort`` simply drops the pending result (an
in-flight XLA program cannot be interrupted, but its effects are purely
functional — ignoring the output IS the abort; the reference's mbStopGBA
has the same observable behavior: corrections are never applied).

Identity across the GBA window: KF slots RECYCLE after culling
(mapstate/state.py), so slot identity is the per-slot insertion sequence —
a slot is the same keyframe iff ``kf_seq`` is unchanged and valid on both
sides; KFs born during the GBA have ``kf_seq >= `` the snapshot's ``n_kf``
counter.  Map-point slots also recycle; a slot is the same point iff it is
valid on both sides with unchanged ``mp_first_kf`` (which stores the first
observer's kf_seq — a recycled slot's first observer is a KF inserted
after the snapshot).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mam3slam_tpu.geometry import lie
from mam3slam_tpu.slam import steps
from mam3slam_tpu.solvers import ba_window as bw
from mam3slam_tpu.solvers import pgo as pgo_mod


class BackgroundGBA:
    """Manages at most one in-flight global BA for a SlamSystem."""

    def __init__(self, system, device=None, iters: int = 10,
                 cg_iters: int = 40):
        self.sys = system
        self.device = device
        cfg = system.cfg
        is2 = jnp.asarray(cfg.inv_sigma2)
        kind = cfg.cam_kind

        @jax.jit
        def compute(ms, map_id):
            from mam3slam_tpu.mapstate import state as S
            in_map = ms.kf_valid & (ms.kf_map == map_id)
            # same gauge anchor as the synchronous global_ba: the OLDEST
            # keyframe of the map by kf_seq (slots recycle)
            anchor = jnp.argmin(jnp.where(in_map, ms.kf_seq, S.BIG_SEQ))
            opt_mask = in_map.at[anchor].set(False)
            prob = steps.build_window_problem(ms, opt_mask, is2,
                                              cfg.max_kf, cfg.max_mp,
                                              with_cm=False)
            res = bw.run_window_ba_dense(prob, kind, iters=iters)
            ms2 = steps.apply_window_result(ms, prob, res)
            return (ms2.kf_q, ms2.kf_t, ms2.mp_pos, opt_mask,
                    steps.window_pt_mask(ms, prob))

        self._compute = compute
        self._pending = None  # (outputs tuple, snapshot dict)

    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._pending is not None

    def start(self, map_id: int) -> None:
        """Snapshot current state and dispatch the GBA program (async)."""
        assert not self.running
        ms = self.sys.ms
        snap = dict(
            map_id=int(map_id),
            n_kf=int(ms.n_kf),
            kf_seq=np.asarray(ms.kf_seq),
            kf_q=np.asarray(ms.kf_q),
            kf_t=np.asarray(ms.kf_t),
            mp_first_kf=np.asarray(ms.mp_first_kf),
        )
        if self.device is not None:
            ms = jax.device_put(ms, self.device)
            map_arg = jax.device_put(jnp.asarray(map_id, jnp.int32),
                                     self.device)
        else:
            map_arg = jnp.asarray(map_id, jnp.int32)
        out = self._compute(ms, map_arg)
        self._pending = (out, snap)

    def abort(self) -> None:
        """Drop the pending result (reference mbStopGBA :2300-2313)."""
        self._pending = None

    @property
    def ready(self) -> bool:
        if not self.running:
            return False
        out, _ = self._pending
        try:
            return all(a.is_ready() for a in out)
        except AttributeError:  # older jax Array without is_ready
            return True

    # ------------------------------------------------------------------
    def finish(self) -> bool:
        """Reconcile the GBA result into the (possibly grown) current
        state.  Returns True if corrections were applied."""
        assert self.running
        out, snap = self._pending
        self._pending = None
        q_g = np.asarray(out[0])
        t_g = np.asarray(out[1])
        pos_g = np.asarray(out[2])
        opt_g = np.asarray(out[3])
        ptf_g = np.asarray(out[4])

        sysm = self.sys
        ms = sysm.ms
        map_id = snap["map_id"]
        n_snap = snap["n_kf"]
        kf_valid = np.asarray(ms.kf_valid)
        kf_map = np.asarray(ms.kf_map)
        parent = np.asarray(ms.kf_parent)
        q_now = np.asarray(ms.kf_q)
        t_now = np.asarray(ms.kf_t)
        K = kf_valid.shape[0]

        # direct write-back: optimized KFs still alive (same kf_seq — the
        # slot was not culled + recycled during the GBA) in the same map
        kf_seq = np.asarray(ms.kf_seq)
        same_kf = kf_valid & (kf_seq == snap["kf_seq"])
        upd = opt_g & same_kf & (kf_map == map_id)
        if not upd.any():
            return False

        q_new = q_now.copy()
        t_new = t_now.copy()
        q_new[upd] = q_g[upd]
        t_new[upd] = t_g[upd]

        # spanning-tree catch-up for KFs born during the GBA
        # (reference :3648-3721): T_new(child) = T_rel * T_new(parent),
        # T_rel from the *current* (uncorrected) estimates.  kf_seq order
        # is creation order, so parents are processed first (slot order is
        # not — slots recycle).
        corrected = upd.copy()
        born = np.where(kf_valid & (kf_map == map_id)
                        & (kf_seq >= n_snap))[0]
        for k in born[np.argsort(kf_seq[born], kind="stable")]:
            p = parent[k]
            if p < 0 or not corrected[p]:
                continue
            T_k = lie.SE3(jnp.asarray(q_now[k]), jnp.asarray(t_now[k]))
            T_p = lie.SE3(jnp.asarray(q_now[p]), jnp.asarray(t_now[p]))
            T_rel = lie.se3_compose(T_k, lie.se3_inverse(T_p))
            T_pn = lie.SE3(jnp.asarray(q_new[p]), jnp.asarray(t_new[p]))
            T_kn = lie.se3_compose(T_rel, T_pn)
            q_new[k] = np.asarray(T_kn.q)
            t_new[k] = np.asarray(T_kn.t)
            corrected[k] = True

        # map points optimized by the GBA and still the same point
        mp_valid = np.asarray(ms.mp_valid)
        mp_map = np.asarray(ms.mp_map)
        first_now = np.asarray(ms.mp_first_kf)
        same_pt = (ptf_g & mp_valid & (mp_map == map_id)
                   & (first_now == snap["mp_first_kf"])
                   & (first_now < n_snap))
        pos_new = np.asarray(ms.mp_pos).copy()
        pos_new[same_pt] = pos_g[same_pt]

        # remaining live points of the map: correct through the reference
        # KF's before/after transform (reference :3773-3800)
        mp_ref = np.asarray(ms.mp_ref_kf)
        ref_ok = (mp_ref >= 0) & corrected[np.clip(mp_ref, 0, K - 1)]
        rest = mp_valid & (mp_map == map_id) & ~same_pt & ref_ok
        if rest.any():
            ones = jnp.ones((K,), jnp.float32)
            moved = pgo_mod.correct_points_by_ref(
                jnp.asarray(pos_new), ms.mp_ref_kf, jnp.asarray(rest),
                jnp.asarray(q_now), jnp.asarray(t_now), ones,
                jnp.asarray(q_new), jnp.asarray(t_new), ones)
            pos_new = np.asarray(moved)

        sysm.ms = ms._replace(
            kf_q=jnp.asarray(q_new), kf_t=jnp.asarray(t_new),
            mp_pos=jnp.asarray(pos_new),
            map_change=ms.map_change.at[map_id].add(1))
        return True

"""Struct-of-arrays map state: the Atlas / Map / KeyFrame / MapPoint model.

JAX-native replacement for the reference's pointer-graph map data model
(SURVEY.md §2.3: ``src/{Frame,KeyFrame,MapPoint,Map,Atlas}.cc``).  Design per
SURVEY.md §7: "state as arrays, not pointer graphs" — fixed-capacity arrays
with validity masks; culled = mask cleared + slot recycled; IDs are slot
indices; the multi-map Atlas is a per-slot ``map_id`` label over ONE arena,
so Sim3 map merges become masked pose transforms + relabeling instead of
container surgery.

Kept relations (the reference's semantics):
* forward observations  ``kf_feat_mp [K, F]``: feature -> map point (-1 none)
  (KeyFrame::mvpMapPoints)
* reverse observations  ``mp_obs_kf/feat [P, M]``: map point -> (kf, feat)
  (MapPoint::mObservations, capacity-capped)
* covisibility weights  ``covis [K, K]`` i32, maintained incrementally
  (KeyFrame::UpdateConnections, weight = #shared map points)
* spanning tree ``kf_parent`` (KeyFrame::mpParent)
* persistent loop/merge edges ``loop_i/loop_j/loop_valid``
  (KeyFrame::mspLoopEdges, include/KeyFrame.h:244-248)

All mutators are pure: they take and return a ``MapState``.  Everything is
jit-able with static capacities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

NO_MP = jnp.int32(-1)
NO_KF = jnp.int32(-1)
BIG_SEQ = jnp.int32(1 << 30)  # kf_seq sentinel for free slots


@dataclass(frozen=True)
class MapConfig:
    max_kf: int = 512
    max_mp: int = 24576
    n_feat: int = 768          # per-KF feature capacity (OrbConfig.capacity)
    max_obs: int = 16          # per-MP reverse-observation capacity
    max_maps: int = 8
    max_loop_edges: int = 64
    n_levels: int = 8
    scale_factor: float = 1.2


class MapState(NamedTuple):
    """The shared multi-map arena; a pytree of fixed-shape arrays."""

    # --- keyframes
    kf_q: jnp.ndarray          # [K, 4] T_cw rotation (world->cam)
    kf_t: jnp.ndarray          # [K, 3]
    kf_valid: jnp.ndarray      # [K] bool
    kf_agent: jnp.ndarray      # [K] i32 creating agent
    kf_map: jnp.ndarray        # [K] i32 map id
    kf_ts: jnp.ndarray         # [K] f32 timestamp
    kf_parent: jnp.ndarray     # [K] i32 spanning-tree parent (-1 root)
    kf_agent_kf_id: jnp.ndarray  # [K] i32 per-agent sequential id
    kf_seq: jnp.ndarray        # [K] i32 global insertion sequence (the
                               # n_kf counter at insert; BIG_SEQ when the
                               # slot is free).  Slots RECYCLE after
                               # KeyFrame culling — creation order /
                               # identity questions must use kf_seq, never
                               # the slot index.
    kf_cam: jnp.ndarray        # [K, 8] f32 per-KF camera intrinsics
                               # (Atlas camera registry, Atlas.h:95-96 —
                               # agents may carry different calibrations)
    # --- per-KF features
    kf_feat_uv: jnp.ndarray    # [K, F, 2] f32 match-space coords
    kf_feat_level: jnp.ndarray  # [K, F] i32
    kf_feat_angle: jnp.ndarray  # [K, F] f32
    kf_feat_desc: jnp.ndarray  # [K, F, 32] u8
    kf_feat_valid: jnp.ndarray  # [K, F] bool
    kf_feat_mp: jnp.ndarray    # [K, F] i32 -> mp slot or -1
    # --- map points
    mp_pos: jnp.ndarray        # [P, 3] f32 world
    mp_valid: jnp.ndarray      # [P] bool
    mp_map: jnp.ndarray        # [P] i32
    mp_desc: jnp.ndarray       # [P, 32] u8 distinctive descriptor
    mp_normal: jnp.ndarray     # [P, 3] f32 mean viewing direction
    mp_min_dist: jnp.ndarray   # [P] f32 scale-invariance bounds
    mp_max_dist: jnp.ndarray   # [P] f32
    mp_first_agent: jnp.ndarray  # [P] i32 creating agent (reference
                               # MapPoint::mnFirstKFAgentId,
                               # include/MapPoint.h:171-172)
    mp_first_agent_kf: jnp.ndarray  # [P] i32 creating agent's per-agent
                               # KF id (mnFirstKFagentLevelId) — culling
                               # recency windows count THIS agent's own
                               # insertions, so interleaved agents never
                               # age each other's fresh points
    mp_ref_kf: jnp.ndarray     # [P] i32 reference keyframe
    mp_first_kf: jnp.ndarray   # [P] i32 kf_seq of the first-observing KF
                               # (recency culling + slot-recycle identity)
    mp_found: jnp.ndarray      # [P] f32 tracking found count
    mp_visible: jnp.ndarray    # [P] f32 tracking visible count
    # --- reverse observations
    mp_obs_kf: jnp.ndarray     # [P, M] i32 kf slot or -1
    mp_obs_feat: jnp.ndarray   # [P, M] i32 feature index in that kf
    mp_nobs: jnp.ndarray       # [P] i32
    # --- graph
    covis: jnp.ndarray         # [K, K] i32 shared-point counts (symmetric)
    # persistent loop/merge edges (KeyFrame::mspLoopEdges/mspMergeEdges,
    # include/KeyFrame.h:244-248): KF-slot pairs whose RELATIVE Sim3 at
    # PGO time is a constraint in every OptimizeEssentialGraph — without
    # them a second loop closure re-opens the first
    loop_i: jnp.ndarray        # [L] i32 KF slot (-1 free)
    loop_j: jnp.ndarray        # [L] i32
    loop_valid: jnp.ndarray    # [L] bool
    # --- counters / maps
    n_kf: jnp.ndarray          # [] i32 monotonic insertion COUNTER (not a
                               # live count, not a slot bound — see kf_seq)
    map_valid: jnp.ndarray     # [Mmax] bool
    map_change: jnp.ndarray    # [Mmax] i32 change index (Map::mnMapChange)


def init_map_state(cfg: MapConfig) -> MapState:
    K, F, P, M = cfg.max_kf, cfg.n_feat, cfg.max_mp, cfg.max_obs
    return MapState(
        kf_q=jnp.zeros((K, 4), jnp.float32).at[:, 0].set(1.0),
        kf_t=jnp.zeros((K, 3), jnp.float32),
        kf_valid=jnp.zeros((K,), bool),
        kf_agent=jnp.full((K,), -1, jnp.int32),
        kf_map=jnp.full((K,), -1, jnp.int32),
        kf_ts=jnp.zeros((K,), jnp.float32),
        kf_parent=jnp.full((K,), NO_KF, jnp.int32),
        kf_agent_kf_id=jnp.full((K,), -1, jnp.int32),
        kf_seq=jnp.full((K,), BIG_SEQ, jnp.int32),
        kf_cam=jnp.zeros((K, 8), jnp.float32),
        kf_feat_uv=jnp.zeros((K, F, 2), jnp.float32),
        kf_feat_level=jnp.zeros((K, F), jnp.int32),
        kf_feat_angle=jnp.zeros((K, F), jnp.float32),
        kf_feat_desc=jnp.zeros((K, F, 32), jnp.uint8),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_feat_mp=jnp.full((K, F), NO_MP, jnp.int32),
        mp_pos=jnp.zeros((P, 3), jnp.float32),
        mp_valid=jnp.zeros((P,), bool),
        mp_map=jnp.full((P,), -1, jnp.int32),
        mp_desc=jnp.zeros((P, 32), jnp.uint8),
        mp_normal=jnp.zeros((P, 3), jnp.float32),
        mp_min_dist=jnp.zeros((P,), jnp.float32),
        mp_max_dist=jnp.zeros((P,), jnp.float32),
        mp_first_agent=jnp.full((P,), -1, jnp.int32),
        mp_first_agent_kf=jnp.full((P,), -1, jnp.int32),
        mp_ref_kf=jnp.full((P,), NO_KF, jnp.int32),
        mp_first_kf=jnp.full((P,), NO_KF, jnp.int32),
        mp_found=jnp.zeros((P,), jnp.float32),
        mp_visible=jnp.zeros((P,), jnp.float32),
        mp_obs_kf=jnp.full((P, M), NO_KF, jnp.int32),
        mp_obs_feat=jnp.full((P, M), -1, jnp.int32),
        mp_nobs=jnp.zeros((P,), jnp.int32),
        covis=jnp.zeros((K, K), jnp.int32),
        loop_i=jnp.full((cfg.max_loop_edges,), NO_KF, jnp.int32),
        loop_j=jnp.full((cfg.max_loop_edges,), NO_KF, jnp.int32),
        loop_valid=jnp.zeros((cfg.max_loop_edges,), bool),
        n_kf=jnp.asarray(0, jnp.int32),
        map_valid=jnp.zeros((cfg.max_maps,), bool),
        map_change=jnp.zeros((cfg.max_maps,), jnp.int32),
    )


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def alloc_mp_slots(ms: MapState, want: jnp.ndarray):
    """Return (slots, granted) for free map-point slot requests (recycled).

    ``want [N] bool`` marks real requests; request i gets the rank(i)-th
    free slot (stable low-index-first).  ``granted`` clears requests that
    overflow the arena — the defined full-arena behavior is DROP (callers
    must only mark granted slots valid); SlamSystem counts the drops and
    warns (``mp_dropped``)."""
    free_first = jnp.argsort(ms.mp_valid.astype(jnp.int32), stable=True)
    ranks = jnp.cumsum(want.astype(jnp.int32)) - 1
    P = ms.mp_valid.shape[0]
    n_free = jnp.sum(~ms.mp_valid)
    granted = want & (ranks < n_free)
    return (free_first[jnp.clip(ranks, 0, P - 1)].astype(jnp.int32),
            granted)


def mp_add_observation(ms: MapState, mp: jnp.ndarray, kf: jnp.ndarray,
                       feat: jnp.ndarray, ok: jnp.ndarray) -> MapState:
    """Batch add reverse+forward observations.  mp/kf/feat [N]; ok mask.

    Duplicate-slot writes within the batch are resolved by (stable) scatter
    order; callers must not add two observations of the same mp in one call
    unless they target different obs slots (we serialize via cumsum ranks).
    """
    # reverse: place each new obs at slot mp_nobs[mp] + rank within batch
    order = jnp.cumsum(ok.astype(jnp.int32)) - 1
    # rank of this obs among same-mp entries in the batch
    N = mp.shape[0]
    P, M = ms.mp_obs_kf.shape
    # per-mp running count within batch: use segment trick
    same = (mp[:, None] == mp[None, :]) & ok[:, None] & ok[None, :]
    before = jnp.tril(same, k=-1).sum(axis=1)
    slot = jnp.clip(ms.mp_nobs[mp] + before, 0, M - 1)
    mp_w = jnp.where(ok, mp, P - 1)  # dump no-ops into a scratch slot
    obs_kf = ms.mp_obs_kf.at[mp_w, slot].set(
        jnp.where(ok, kf, ms.mp_obs_kf[mp_w, slot]))
    obs_feat = ms.mp_obs_feat.at[mp_w, slot].set(
        jnp.where(ok, feat, ms.mp_obs_feat[mp_w, slot]))
    nobs = ms.mp_nobs.at[mp_w].add(jnp.where(ok, 1, 0))
    nobs = jnp.minimum(nobs, M)
    # forward
    kf_w = jnp.where(ok, kf, ms.kf_feat_mp.shape[0] - 1)
    feat_w = jnp.where(ok, feat, 0)
    fmp = ms.kf_feat_mp.at[kf_w, feat_w].set(
        jnp.where(ok, mp, ms.kf_feat_mp[kf_w, feat_w]))
    return ms._replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_feat,
                       mp_nobs=nobs, kf_feat_mp=fmp)


def covis_row(ms: MapState, kf: jnp.ndarray) -> jnp.ndarray:
    """Recompute covisibility weights of one KF vs all others from the
    forward observation table: weight = |shared map points|."""
    P = ms.mp_pos.shape[0]
    mps = ms.kf_feat_mp[kf]  # [F]
    member = jnp.zeros((P + 1,), jnp.int32).at[
        jnp.where(mps >= 0, mps, P)].set(1).at[P].set(0)
    other = jnp.where(ms.kf_feat_mp >= 0, ms.kf_feat_mp, P)  # [K, F]
    counts = jnp.sum(member[other], axis=1).astype(jnp.int32)  # [K]
    counts = jnp.where(ms.kf_valid, counts, 0)
    return counts.at[kf].set(0)


def update_covis_for_kf(ms: MapState, kf: jnp.ndarray) -> MapState:
    row = covis_row(ms, kf)
    covis = ms.covis.at[kf, :].set(row).at[:, kf].set(row)
    return ms._replace(covis=covis)


def best_covisible(ms: MapState, kf: jnp.ndarray, n: int,
                   min_weight: int = 1):
    """Top-n covisible KFs of `kf` (GetBestCovisibilityKeyFrames)."""
    wrow = jnp.where(ms.kf_valid, ms.covis[kf], 0)
    n = min(n, wrow.shape[0])  # tiny arenas: window clamps to capacity
    w, idx = jax.lax.top_k(wrow, n)
    ok = w >= min_weight
    return idx.astype(jnp.int32), w, ok


def assign_spanning_parent(ms: MapState, kf: jnp.ndarray) -> MapState:
    """parent = strongest covisible created EARLIER (first connection,
    KeyFrame::UpdateConnections + mbFirstConnection semantics).  Earlier =
    smaller kf_seq — slot indices recycle and do not order creation."""
    wrow = ms.covis[kf] * (ms.kf_seq < ms.kf_seq[kf])
    parent = jnp.where(jnp.max(wrow) > 0, jnp.argmax(wrow), NO_KF)
    return ms._replace(kf_parent=ms.kf_parent.at[kf].set(
        parent.astype(jnp.int32)))


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------

def add_keyframe(ms: MapState, q, t, agent, map_id, ts, agent_kf_id,
                 feat_uv, feat_level, feat_angle, feat_desc, feat_valid,
                 feat_mp, cam_params=None) -> tuple:
    """Insert a keyframe into the first free slot; returns (ms, kf_slot).

    Slots freed by KeyFrame culling are RECYCLED (lowest free slot first).
    When the arena is full, ``argmax`` degenerates to slot 0 and would
    silently corrupt it — callers must guard on the host with
    ``kf_valid.sum() < max_kf`` (SlamSystem raises MapCapacityError).

    ``feat_mp [F]`` carries tracked map-point associations (-1 = none);
    reverse observations and covisibility are updated here (the reference
    does this in Tracking::CreateNewKeyFrame + ProcessNewKeyFrame).
    """
    kf = jnp.argmax(~ms.kf_valid).astype(jnp.int32)
    F = feat_uv.shape[0]
    ms = ms._replace(
        kf_q=ms.kf_q.at[kf].set(q),
        kf_t=ms.kf_t.at[kf].set(t),
        kf_valid=ms.kf_valid.at[kf].set(True),
        kf_agent=ms.kf_agent.at[kf].set(agent),
        kf_map=ms.kf_map.at[kf].set(map_id),
        kf_ts=ms.kf_ts.at[kf].set(ts),
        kf_agent_kf_id=ms.kf_agent_kf_id.at[kf].set(agent_kf_id),
        kf_seq=ms.kf_seq.at[kf].set(ms.n_kf),
        kf_cam=(ms.kf_cam if cam_params is None
                else ms.kf_cam.at[kf].set(cam_params)),
        kf_feat_uv=ms.kf_feat_uv.at[kf].set(feat_uv),
        kf_feat_level=ms.kf_feat_level.at[kf].set(feat_level),
        kf_feat_angle=ms.kf_feat_angle.at[kf].set(feat_angle),
        kf_feat_desc=ms.kf_feat_desc.at[kf].set(feat_desc),
        kf_feat_valid=ms.kf_feat_valid.at[kf].set(feat_valid),
        kf_feat_mp=ms.kf_feat_mp.at[kf].set(jnp.full((F,), NO_MP, jnp.int32)),
        n_kf=ms.n_kf + 1,
    )
    ok = (feat_mp >= 0) & feat_valid & ms.mp_valid[jnp.clip(feat_mp, 0)]
    ms = mp_add_observation(
        ms, jnp.clip(feat_mp, 0), jnp.full((F,), kf, jnp.int32),
        jnp.arange(F, dtype=jnp.int32), ok)
    ms = update_covis_for_kf(ms, kf)
    ms = assign_spanning_parent(ms, kf)
    return ms, kf


# ---------------------------------------------------------------------------
# map point maintenance
# ---------------------------------------------------------------------------

def refresh_mp_stats(ms: MapState, mp_mask: jnp.ndarray,
                     scale_factors: jnp.ndarray) -> MapState:
    """Recompute distinctive descriptor, normal, and scale-invariance depth
    bounds for masked map points from their observations (reference
    ``MapPoint::ComputeDistinctiveDescriptors`` + ``UpdateNormalAndDepth``).
    """
    P, M = ms.mp_obs_kf.shape
    obs_ok = (jnp.arange(M)[None, :] < ms.mp_nobs[:, None]) & (
        ms.mp_obs_kf >= 0)
    kf = jnp.clip(ms.mp_obs_kf, 0)
    obs_ok = obs_ok & ms.kf_valid[kf]
    feat = jnp.clip(ms.mp_obs_feat, 0)

    # descriptors of all observations [P, M, 32]
    descs = ms.kf_feat_desc[kf, feat]
    # pairwise Hamming inside each point's observation set
    x = jnp.bitwise_xor(descs[:, :, None, :], descs[:, None, :, :])
    pair = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
    big = jnp.int32(1 << 15)
    pair = jnp.where(obs_ok[:, :, None] & obs_ok[:, None, :], pair, big)
    # median distance per row (reference takes median then min)
    sorted_pair = jnp.sort(pair, axis=-1)
    n_ok = jnp.sum(obs_ok, axis=-1)  # [P]
    med_idx = jnp.clip((n_ok[:, None] - 1) // 2, 0, M - 1)
    med = jnp.take_along_axis(
        sorted_pair, jnp.broadcast_to(med_idx[..., None], pair.shape[:2] + (1,)),
        axis=-1)[..., 0]
    med = jnp.where(obs_ok, med, big)
    best_obs = jnp.argmin(med, axis=-1)  # [P]
    new_desc = descs[jnp.arange(P), best_obs]

    # normal + depth bounds from reference KF (first obs) distance
    cam_center = -jax.vmap(
        lambda q, t: jnp.einsum("ij,j->i", jnp.transpose(_qmat(q)), t,
                                precision=jax.lax.Precision.HIGHEST))(
        ms.kf_q[kf.reshape(-1)], ms.kf_t[kf.reshape(-1)]).reshape(P, M, 3)
    vec = ms.mp_pos[:, None, :] - cam_center
    dist = jnp.linalg.norm(vec, axis=-1)
    dirs = vec / jnp.maximum(dist[..., None], 1e-9)
    normal = jnp.sum(jnp.where(obs_ok[..., None], dirs, 0.0), axis=1)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # reference obs = first valid observation slot
    first_slot = jnp.argmax(obs_ok, axis=-1)
    ref_kf = ms.mp_obs_kf[jnp.arange(P), first_slot]
    ref_feat = ms.mp_obs_feat[jnp.arange(P), first_slot]
    ref_level = ms.kf_feat_level[jnp.clip(ref_kf, 0), jnp.clip(ref_feat, 0)]
    ref_dist = dist[jnp.arange(P), first_slot]
    lvl_factor = scale_factors[jnp.clip(ref_level, 0)]
    n_levels = scale_factors.shape[0]
    max_dist = ref_dist * lvl_factor
    min_dist = max_dist / scale_factors[n_levels - 1]

    upd = mp_mask & (n_ok > 0)
    return ms._replace(
        mp_desc=jnp.where(upd[:, None], new_desc, ms.mp_desc),
        mp_normal=jnp.where(upd[:, None], normal, ms.mp_normal),
        mp_min_dist=jnp.where(upd, min_dist, ms.mp_min_dist),
        mp_max_dist=jnp.where(upd, max_dist, ms.mp_max_dist),
        mp_ref_kf=jnp.where(upd, ref_kf, ms.mp_ref_kf),
    )


def _qmat(q):
    from mam3slam_tpu.geometry import lie
    return lie.quat_to_matrix(q)


def refresh_mp_stats_compact(ms: MapState, idx: jnp.ndarray,
                             scale_factors: jnp.ndarray) -> MapState:
    """``refresh_mp_stats`` for a COMPACT index batch ``idx [C]`` (-1 =
    padding).  A mapping epoch only touches O(F) points (new
    triangulations + fuse survivors), so recomputing distinctive
    descriptors / normals / depth bounds over the full arena — the
    reference updates per-point in ``MapPoint::UpdateNormalAndDepth`` —
    wastes P/C of the work; this gathers the C affected rows, runs the
    identical math, and scatters back (unique indices)."""
    C = idx.shape[0]
    P, M = ms.mp_obs_kf.shape
    ok_row = idx >= 0
    pi = jnp.clip(idx, 0)
    obs_kf = ms.mp_obs_kf[pi]                              # [C, M]
    obs_feat = ms.mp_obs_feat[pi]
    nobs = ms.mp_nobs[pi]
    obs_ok = (jnp.arange(M)[None, :] < nobs[:, None]) & (obs_kf >= 0)
    kf = jnp.clip(obs_kf, 0)
    obs_ok = obs_ok & ms.kf_valid[kf]
    feat = jnp.clip(obs_feat, 0)

    descs = ms.kf_feat_desc[kf, feat]                      # [C, M, 32]
    x = jnp.bitwise_xor(descs[:, :, None, :], descs[:, None, :, :])
    pair = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
    big = jnp.int32(1 << 15)
    pair = jnp.where(obs_ok[:, :, None] & obs_ok[:, None, :], pair, big)
    sorted_pair = jnp.sort(pair, axis=-1)
    n_ok = jnp.sum(obs_ok, axis=-1)
    med_idx = jnp.clip((n_ok[:, None] - 1) // 2, 0, M - 1)
    med = jnp.take_along_axis(
        sorted_pair,
        jnp.broadcast_to(med_idx[..., None], pair.shape[:2] + (1,)),
        axis=-1)[..., 0]
    med = jnp.where(obs_ok, med, big)
    best_obs = jnp.argmin(med, axis=-1)
    new_desc = descs[jnp.arange(C), best_obs]

    from mam3slam_tpu.geometry import lie
    q_o = ms.kf_q[kf]                                      # [C, M, 4]
    t_o = ms.kf_t[kf]
    cam_center = -lie.quat_rotate(lie.quat_conj(q_o), t_o)
    pos = ms.mp_pos[pi]
    vec = pos[:, None, :] - cam_center
    dist = jnp.linalg.norm(vec, axis=-1)
    dirs = vec / jnp.maximum(dist[..., None], 1e-9)
    normal = jnp.sum(jnp.where(obs_ok[..., None], dirs, 0.0), axis=1)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    first_slot = jnp.argmax(obs_ok, axis=-1)
    ref_kf = obs_kf[jnp.arange(C), first_slot]
    ref_feat = obs_feat[jnp.arange(C), first_slot]
    ref_level = ms.kf_feat_level[jnp.clip(ref_kf, 0), jnp.clip(ref_feat, 0)]
    ref_dist = dist[jnp.arange(C), first_slot]
    lvl_factor = scale_factors[jnp.clip(ref_level, 0)]
    n_levels = scale_factors.shape[0]
    max_dist = ref_dist * lvl_factor
    min_dist = max_dist / scale_factors[n_levels - 1]

    upd = ok_row & (n_ok > 0) & ms.mp_valid[pi]
    # scatter back (inactive rows routed to a scratch row)
    w = jnp.where(upd, pi, P)
    pad = lambda a, fill: jnp.concatenate(
        [a, jnp.zeros((1,) + a.shape[1:], a.dtype)], 0)
    mp_desc = pad(ms.mp_desc, 0).at[w].set(
        jnp.where(upd[:, None], new_desc, pad(ms.mp_desc, 0)[w]))[:P]
    mp_normal = pad(ms.mp_normal, 0).at[w].set(
        jnp.where(upd[:, None], normal, pad(ms.mp_normal, 0)[w]))[:P]
    mp_min = pad(ms.mp_min_dist, 0).at[w].set(
        jnp.where(upd, min_dist, pad(ms.mp_min_dist, 0)[w]))[:P]
    mp_max = pad(ms.mp_max_dist, 0).at[w].set(
        jnp.where(upd, max_dist, pad(ms.mp_max_dist, 0)[w]))[:P]
    mp_ref = pad(ms.mp_ref_kf, 0).at[w].set(
        jnp.where(upd, ref_kf, pad(ms.mp_ref_kf, 0)[w]))[:P]
    return ms._replace(mp_desc=mp_desc, mp_normal=mp_normal,
                       mp_min_dist=mp_min, mp_max_dist=mp_max,
                       mp_ref_kf=mp_ref)


def compact_indices(mask: jnp.ndarray, cap: int) -> jnp.ndarray:
    """First ``cap`` set indices of ``mask`` (stable), -1-padded [cap]."""
    order = jnp.argsort(~mask, stable=True).astype(jnp.int32)
    sel = order[:cap]
    return jnp.where(mask[sel], sel, -1)


def remove_map_points(ms: MapState, kill_mask: jnp.ndarray) -> MapState:
    """SetBadFlag for a batch of map points: clear forward links (scan all
    KF feature tables), reverse table, and validity."""
    fmp = ms.kf_feat_mp
    hit = (fmp >= 0) & kill_mask[jnp.clip(fmp, 0)]
    fmp = jnp.where(hit, NO_MP, fmp)
    return ms._replace(
        kf_feat_mp=fmp,
        mp_valid=ms.mp_valid & ~kill_mask,
        mp_nobs=jnp.where(kill_mask, 0, ms.mp_nobs),
        mp_obs_kf=jnp.where(kill_mask[:, None], NO_KF, ms.mp_obs_kf),
        mp_obs_feat=jnp.where(kill_mask[:, None], -1, ms.mp_obs_feat),
    )


def replace_map_points(ms: MapState, src: jnp.ndarray, dst: jnp.ndarray,
                       ok: jnp.ndarray) -> MapState:
    """MapPoint::Replace for batches: redirect every forward link from
    ``src[i]`` to ``dst[i]`` and kill src.  Reverse tables of dst are
    rebuilt lazily by ``rebuild_reverse_obs`` (cheaper than merging under
    capacity constraints, and equivalent)."""
    P = ms.mp_valid.shape[0]
    lut = jnp.arange(P, dtype=jnp.int32)
    lut = lut.at[jnp.where(ok, src, P - 1)].set(
        jnp.where(ok, dst, lut[jnp.where(ok, src, P - 1)]))
    fmp = ms.kf_feat_mp
    fmp = jnp.where(fmp >= 0, lut[jnp.clip(fmp, 0)], fmp)
    kill = jnp.zeros((P,), bool).at[jnp.where(ok, src, P - 1)].set(
        jnp.where(ok, True, False))
    found = ms.mp_found.at[jnp.where(ok, dst, P - 1)].add(
        jnp.where(ok, ms.mp_found[jnp.clip(src, 0, P - 1)], 0.0))
    visible = ms.mp_visible.at[jnp.where(ok, dst, P - 1)].add(
        jnp.where(ok, ms.mp_visible[jnp.clip(src, 0, P - 1)], 0.0))
    return ms._replace(kf_feat_mp=fmp, mp_valid=ms.mp_valid & ~kill,
                       mp_found=found, mp_visible=visible,
                       mp_nobs=jnp.where(kill, 0, ms.mp_nobs))


def rebuild_reverse_obs(ms: MapState) -> MapState:
    """Rebuild mp_obs_* tables from the forward kf_feat_mp table.

    Used after fuse/replace batches; one pass over the [K, F] table.
    """
    K, F = ms.kf_feat_mp.shape
    P, M = ms.mp_obs_kf.shape
    fmp = ms.kf_feat_mp
    flat_mp = fmp.reshape(-1)
    flat_kf = jnp.repeat(jnp.arange(K, dtype=jnp.int32), F)
    flat_feat = jnp.tile(jnp.arange(F, dtype=jnp.int32), K)
    ok = (flat_mp >= 0) & ms.kf_valid[flat_kf] & ms.mp_valid[
        jnp.clip(flat_mp, 0)]
    tgt = jnp.where(ok, flat_mp, P)  # P = scratch row
    # slot within each mp's list = running count of earlier observations
    # use sort-based ranking: stable sort by target mp
    order = jnp.argsort(tgt, stable=True)
    sorted_tgt = tgt[order]
    # rank within equal-tgt runs
    idx = jnp.arange(sorted_tgt.shape[0])
    first_of_run = jnp.where(
        jnp.concatenate([jnp.array([True]),
                         sorted_tgt[1:] != sorted_tgt[:-1]]), idx, 0)
    run_start = jax.lax.associative_scan(jnp.maximum, first_of_run)
    rank = (idx - run_start).astype(jnp.int32)

    obs_kf = jnp.full((P + 1, M), NO_KF, jnp.int32)
    obs_feat = jnp.full((P + 1, M), -1, jnp.int32)
    in_cap = rank < M
    w_tgt = jnp.where(in_cap, sorted_tgt, P)
    w_rank = jnp.where(in_cap, rank, 0)
    obs_kf = obs_kf.at[w_tgt, w_rank].set(
        jnp.where(in_cap, flat_kf[order], NO_KF))
    obs_feat = obs_feat.at[w_tgt, w_rank].set(
        jnp.where(in_cap, flat_feat[order], -1))
    nobs = jnp.zeros((P + 1,), jnp.int32).at[w_tgt].add(
        jnp.where(in_cap, 1, 0))
    return ms._replace(mp_obs_kf=obs_kf[:P], mp_obs_feat=obs_feat[:P],
                       mp_nobs=jnp.minimum(nobs[:P], M))


def add_loop_edge(ms: MapState, i, j) -> MapState:
    """Record a loop/merge edge (KeyFrame::AddLoopEdge / AddMergeEdge).

    On capacity overflow the lowest slot is overwritten (bounded memory;
    the oldest constraint is dropped — the PGO still has spanning tree +
    covisibility there)."""
    slot = jnp.argmax(~ms.loop_valid)
    return ms._replace(
        loop_i=ms.loop_i.at[slot].set(jnp.asarray(i, jnp.int32)),
        loop_j=ms.loop_j.at[slot].set(jnp.asarray(j, jnp.int32)),
        loop_valid=ms.loop_valid.at[slot].set(True))


def remove_keyframe(ms: MapState, kf: jnp.ndarray) -> MapState:
    """KeyFrame::SetBadFlag: drop the KF, its observations, reconnect
    children to its parent in the spanning tree, clear covis row, drop
    loop edges touching it (culling normally never reaches loop-edge
    endpoints — they are protected like the reference's SetNotErase)."""
    K, F = ms.kf_feat_mp.shape
    # decrement reverse obs: rebuild after clearing forward row
    ms = ms._replace(
        kf_valid=ms.kf_valid.at[kf].set(False),
        kf_seq=ms.kf_seq.at[kf].set(BIG_SEQ),
        kf_feat_mp=ms.kf_feat_mp.at[kf].set(
            jnp.full((F,), NO_MP, jnp.int32)),
        covis=ms.covis.at[kf, :].set(0).at[:, kf].set(0),
    )
    parent = ms.kf_parent[kf]
    children = ms.kf_parent == kf
    hit = ((ms.loop_i == kf) | (ms.loop_j == kf)) & ms.loop_valid
    ms = ms._replace(kf_parent=jnp.where(children, parent, ms.kf_parent),
                     loop_valid=ms.loop_valid & ~hit)
    return rebuild_reverse_obs(ms)

"""Two-level host x chip mesh: the multi-host layout, exercised as
far as one machine allows.

SURVEY §2.6/§2.8 map the reference's shared-memory fabric onto a
two-level device mesh: agent front ends data-parallel over the HOST
(network) axis, BA Schur reductions riding the intra-host CHIP (NVLink)
axis.  No multi-host hardware is at hand, so an 8-virtual-
device CPU mesh reshaped to (2 hosts x 4 chips) validates that every
production distributed program compiles + executes with its collectives
pinned to ONE named axis of a 2D mesh (replicated over the other) and
matches single-device results — the exact program a multi-host GPU
cluster would run with ('host', 'chip') = (inter-host network, NVLink).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mam3slam_tpu.geometry import cameras, lie
from mam3slam_tpu.parallel import dist_ba
from mam3slam_tpu.parallel import dist_window_ba as dwb
from mam3slam_tpu.solvers import ba

from test_ba import make_scene, _build_problem, _reproj_rms

import pytest

pytestmark = pytest.mark.slow  # full-suite tier; smoke = -m "not slow"


def _mesh2d(hosts=2, chips=4):
    devs = np.array(jax.devices()[:hosts * chips]).reshape(hosts, chips)
    return Mesh(devs, ("host", "chip"))


def _window_problem(seed=7):
    q, t, pts, oc, op, ouv = make_scene(n_cams=6, n_pts=250, noise_px=0.5,
                                        seed=seed)
    rng = np.random.default_rng(0)
    qp, tp = q.copy(), t.copy()
    tp[2:] += rng.normal(0, 0.05, tp[2:].shape)
    ptsp = (pts + rng.normal(0, 0.08, pts.shape)).astype(np.float32)
    cam_free = np.array([False, False] + [True] * (len(q) - 2))
    prob = _build_problem(qp, tp, ptsp, oc, op, ouv, cam_free,
                          np.ones(len(pts), bool))
    return dwb.window_problem_from_edges(
        prob.cam_q, prob.cam_t, prob.cam_params, prob.pts, prob.obs.cam,
        prob.obs.pt, prob.obs.uv, prob.obs.w, prob.cam_free,
        prob.pt_free), (oc, op, ouv)


def test_window_ba_collectives_ride_chip_axis():
    """Both production window-BA solvers (dense one-psum, psum-CG) run on
    the 'chip' axis of a (2,4) mesh — psums stay intra-host (NVLink),
    state is replicated over 'host' — and match a 1-device solve."""
    wprob, (oc, op, ouv) = _window_problem()
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("chip",))
    mesh2d = _mesh2d()

    n_cams = 6
    for solver, tol in ((dwb.dist_run_window_ba_dense, 5e-3),
                        (dwb.dist_run_window_ba_psum, 2e-2)):
        ref = solver(wprob, mesh1, cameras.PINHOLE, axis="chip", iters=8)
        two = solver(wprob, mesh2d, cameras.PINHOLE, axis="chip", iters=8)
        # camera block is padded to a multiple of the device count; only
        # the real-camera prefix is meaningful
        np.testing.assert_allclose(np.asarray(two.cam_t)[:n_cams],
                                   np.asarray(ref.cam_t)[:n_cams],
                                   atol=tol)
        rms, _ = _reproj_rms(two, oc, op, ouv)
        assert rms < 0.8, rms


def test_agents_shard_over_host_axis():
    """The agent-parallel batched pose optimization shards its agent
    batch over the 'host' (network) axis of the same 2D mesh — per-agent
    work never crosses hosts — and matches the unsharded vmap."""
    n_agents = 8
    scenes = [make_scene(n_cams=1, n_pts=150, noise_px=0.4, seed=50 + i)
              for i in range(n_agents)]
    M = min(min(len(s[4]) for s in scenes), 128)
    qs, ts, ptss, uvs = [], [], [], []
    for q, t, pts, oc, op, ouv in scenes:
        dq = lie.so3_exp_quat(jnp.asarray([0.02, -0.01, 0.02]))
        qs.append(np.asarray(lie.quat_mul(dq, jnp.asarray(q[0]))))
        ts.append(t[0] + np.array([0.05, -0.04, 0.06], np.float32))
        ptss.append(pts[np.asarray(op[:M])])
        uvs.append(np.asarray(ouv[:M], np.float32))
    args = (jnp.asarray(np.stack(qs)), jnp.asarray(np.stack(ts)),
            jnp.broadcast_to(jnp.asarray(
                [458.0, 458.0, 376.0, 240.0, 0, 0, 0, 0], jnp.float32),
                (n_agents, 8)),
            jnp.asarray(np.stack(ptss)), jnp.asarray(np.stack(uvs)),
            jnp.ones((n_agents, M), jnp.float32),
            jnp.ones((n_agents, M), bool))

    fn = dist_ba.batched_pose_optimization(_mesh2d(), cameras.PINHOLE,
                                           axis="host")
    out = fn(*args)
    ref = jax.vmap(lambda q0, t0, cp, pts, uv, w, v: ba.pose_optimization(
        q0, t0, cp, cameras.PINHOLE, pts, uv, w, v,
        use_kernel=False))(*args)
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(ref.t),
                               atol=1e-4)
    assert int(np.asarray(out.n_inliers).min()) > M // 2


def test_global_ba_epoch_on_two_level_mesh():
    """The server's production multi-chip GBA epoch (dist_global_ba, the
    ServerConfig.gba_mesh path) accepts the (host, chip) mesh directly,
    reducing over 'chip'; write-back matches the single-chip epoch."""
    from mam3slam_tpu.slam.system import OK, SlamConfig, SlamSystem
    from test_slam_e2e import (FX, FY, CX, CY, H, N_FEAT, W,
                               SyntheticWorld, make_trajectory)

    world = SyntheticWorld(n_mp=600, seed=3)
    cam = cameras.make_pinhole(FX, FY, CX, CY)
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=64,
                     max_mp=4096, n_levels=4, min_init_matches=60)
    sys_ = SlamSystem(cfg, cam)
    aid = sys_.add_agent()
    for i, (R, t) in enumerate(make_trajectory(40)):
        f, _ = world.render(R, t)
        st, _ = sys_.track(aid, f, float(i))
    assert st == OK
    ms0 = sys_.ms
    map_id = sys_.agents[aid].map_id

    local = sys_.fns["global_ba"](ms0, jnp.asarray(map_id))
    dist = dwb.dist_global_ba(ms0, cfg, _mesh2d(), map_id,
                              cameras.PINHOLE, axis="chip")
    kf_sel = np.asarray(ms0.kf_valid)
    np.testing.assert_allclose(np.asarray(dist.kf_t)[kf_sel],
                               np.asarray(local.kf_t)[kf_sel], atol=5e-3)
    mp_sel = np.asarray(ms0.mp_valid)
    np.testing.assert_allclose(np.asarray(dist.mp_pos)[mp_sel],
                               np.asarray(local.mp_pos)[mp_sel],
                               atol=2e-2)

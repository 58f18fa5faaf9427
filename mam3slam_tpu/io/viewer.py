"""Headless map / trajectory visualization.

Replaces the reference's Pangolin viewers (``src/{MapDrawer, Viewer,
AgentViewer, MultiAgentViewer}.cc`` — SURVEY.md §2.7) with a matplotlib
renderer producing PNG snapshots: map points, keyframe frusta, covisibility
edges, and per-agent trajectories — suitable for headless accelerator hosts (no
GL); the reference's interactive windows don't translate to that setting.
"""

from __future__ import annotations

import numpy as np

from mam3slam_tpu.geometry import lie


def render_map(system, path: str, server=None, max_points: int = 20000):
    """3D map snapshot written to ``path`` (PNG)."""
    import matplotlib
    matplotlib.use("Agg")

    fig = _map_figure(system, server=server, max_points=max_points)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    import matplotlib.pyplot as plt
    plt.close(fig)


def draw_map_image(system, server=None, max_points: int = 20000,
                   figsize=(7, 5.6), dpi: int = 80) -> np.ndarray:
    """The 3D map view as a BGR ndarray — the live MapDrawer window's
    headless twin (reference src/MapDrawer.cc:1-419 renders points, KF
    frusta, covisibility graph and trajectories continuously;
    ``MjpegServer`` streams this image at ~1 Hz on ``/map``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = _map_figure(system, server=server, max_points=max_points,
                      figsize=figsize)
    fig.set_dpi(dpi)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf[..., ::-1]  # RGB -> BGR for the cv2/MJPEG pipeline


def _map_figure(system, server=None, max_points: int = 20000,
                figsize=(10, 8)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ms = system.ms
    fig, ax = plt.subplots(figsize=figsize)
    mp_valid = np.asarray(ms.mp_valid)
    pos = np.asarray(ms.mp_pos)[mp_valid][:max_points]
    maps = np.asarray(ms.mp_map)[mp_valid][:max_points]
    if len(pos):
        ax.scatter(pos[:, 0], pos[:, 2], s=1, c=maps, cmap="tab10",
                   alpha=0.4, label="map points")

    import jax.numpy as jnp
    T_wc = lie.se3_inverse(lie.SE3(ms.kf_q, ms.kf_t))
    C = np.asarray(T_wc.t)
    kf_valid = np.asarray(ms.kf_valid)
    ax.plot(C[kf_valid, 0], C[kf_valid, 2], "k^", markersize=3,
            label="keyframes")

    # covisibility edges
    covis = np.asarray(ms.covis)
    ii, jj = np.where(np.triu(covis, 1) >= 30)
    for i, j in zip(ii[:500], jj[:500]):
        if kf_valid[i] and kf_valid[j]:
            ax.plot([C[i, 0], C[j, 0]], [C[i, 2], C[j, 2]], "g-",
                    linewidth=0.3, alpha=0.5)

    colors = ["C0", "C1", "C2", "C3", "C4", "C5"]
    for a in system.agents:
        traj = system.trajectory_world(a.agent_id)
        xs = [t[0] for _, _, t, st in traj if st == 2]
        zs = [t[2] for _, _, t, st in traj if st == 2]
        ax.plot(xs, zs, colors[a.agent_id % 6], linewidth=1,
                label=f"agent {a.agent_id}")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(f"{int(kf_valid.sum())} KFs, {int(mp_valid.sum())} MPs")
    return fig


def map_snapshot(system, server=None, max_points: int = 4000,
                 max_covis: int = 400) -> dict:
    """JSON-serializable 3D snapshot of the atlas for the interactive
    browser viewer (``MjpegServer`` ``/map3d``) — the rotatable-window
    counterpart of the reference's Pangolin MapDrawer
    (src/MapDrawer.cc:1-419: points, KF frusta, covisibility graph,
    trajectories, all re-drawn each render tick).

    ``points`` [N,3] + per-point map id; ``segs`` [M,6] precomputed line
    segments (frusta, covisibility edges, trajectories) + per-segment
    color class (0 = covis, 1 = KF frustum, 2+a = agent-a trajectory),
    so the client only rotates/projects/draws.
    """
    ms = system.ms
    mp_valid = np.asarray(ms.mp_valid)
    pos = np.asarray(ms.mp_pos)[mp_valid]
    pmap = np.asarray(ms.mp_map)[mp_valid]
    if len(pos) > max_points:
        idx = np.linspace(0, len(pos) - 1, max_points).astype(int)
        pos, pmap = pos[idx], pmap[idx]

    T_wc = lie.se3_inverse(lie.SE3(ms.kf_q, ms.kf_t))
    C = np.asarray(T_wc.t)
    Rwc = np.asarray(lie.quat_to_matrix(T_wc.q))
    kf_valid = np.asarray(ms.kf_valid)

    span = 1.0
    if len(pos) > 3:
        span = float(np.median(np.linalg.norm(
            pos - np.median(pos, axis=0), axis=1))) * 2.0 + 1e-6

    segs, scls = [], []

    # KF frusta: camera center to the 4 image-plane corners + the rect
    # (reference MapDrawer::DrawKeyFrames draws the same 8 GL lines)
    w = 0.06 * span
    h, z = 0.045 * span, 0.075 * span
    corners_c = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
                         np.float32)
    for k in np.flatnonzero(kf_valid):
        cw = (Rwc[k] @ corners_c.T).T + C[k]
        for i in range(4):
            segs.append(np.concatenate([C[k], cw[i]]))
            segs.append(np.concatenate([cw[i], cw[(i + 1) % 4]]))
            scls += [1, 1]

    covis = np.asarray(ms.covis)
    ii, jj = np.where(np.triu(covis, 1) >= 30)
    for i, j in zip(ii[:max_covis], jj[:max_covis]):
        if kf_valid[i] and kf_valid[j]:
            segs.append(np.concatenate([C[i], C[j]]))
            scls.append(0)

    for a in system.agents:
        traj = system.trajectory_world(a.agent_id)
        pts = np.array([t for _, _, t, st in traj if st == 2], np.float32)
        for p, q in zip(pts[:-1], pts[1:]):
            segs.append(np.concatenate([p, q]))
            scls.append(2 + a.agent_id)

    rnd = lambda arr, nd=4: np.round(np.asarray(arr, np.float64), nd)
    return {
        "points": rnd(pos).tolist(),
        "pmap": np.asarray(pmap, int).tolist(),
        "segs": rnd(np.array(segs).reshape(-1, 6)).tolist(),
        "scls": [int(c) for c in scls],
        "span": round(span, 4),
        "stats": {"kfs": int(kf_valid.sum()), "mps": int(mp_valid.sum()),
                  "agents": len(system.agents)},
    }


_STATE_TEXT = {0: "WAITING FOR IMAGES", 1: "TRYING TO INITIALIZE",
               2: "SLAM", 3: "RECENTLY LOST", 4: "LOST"}


def draw_tracking_frame(system, agent_id: int,
                        image: np.ndarray) -> np.ndarray:
    """Annotated per-frame tracking image (the reference FrameDrawer,
    src/FrameDrawer.cc:1-489): keypoints drawn colored by match state —
    green square+dot for features tracking a map point (inlier of the
    last pose optimization), blue dot for extracted-but-unmatched — plus
    the state banner with map statistics.  Returns the BGR image (the
    live viewers stream it; ``render_tracking_frame`` writes it)."""
    import cv2

    a = system.agents[agent_id]
    img = np.asarray(image, np.float32)
    bgr = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                       cv2.COLOR_GRAY2BGR)
    n_tracked = 0
    if a.last_frame is not None:
        uv = np.asarray(a.last_frame.uv)
        valid = np.asarray(a.last_frame.valid)
        fmp = (np.asarray(a.last_feat_mp)
               if a.last_feat_mp is not None
               else np.full(len(uv), -1, np.int32))
        for i in np.flatnonzero(valid):
            x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
            if not (0 <= x < bgr.shape[1] and 0 <= y < bgr.shape[0]):
                continue
            if fmp[i] >= 0:
                cv2.rectangle(bgr, (x - 3, y - 3), (x + 3, y + 3),
                              (0, 200, 0), 1)
                cv2.circle(bgr, (x, y), 1, (0, 200, 0), -1)
                n_tracked += 1
            else:
                cv2.circle(bgr, (x, y), 1, (200, 120, 0), -1)

    ms = system.ms
    n_kf = int(np.asarray(ms.kf_valid).sum())
    n_mp = int(np.asarray(ms.mp_valid).sum())
    state = _STATE_TEXT.get(a.state, "?")
    banner = (f"{state} | agent {agent_id} map {a.map_id} | "
              f"KFs: {n_kf}  MPs: {n_mp}  matches: {n_tracked}")
    bar = np.zeros((22, bgr.shape[1], 3), np.uint8)
    cv2.putText(bar, banner, (6, 15), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                (255, 255, 255), 1, cv2.LINE_AA)
    return np.concatenate([bgr, bar], axis=0)


def render_tracking_frame(system, agent_id: int, image: np.ndarray,
                          path: str):
    """``draw_tracking_frame`` written to disk as PNG (headless use)."""
    import cv2

    cv2.imwrite(path, draw_tracking_frame(system, agent_id, image))

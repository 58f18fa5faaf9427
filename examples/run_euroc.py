#!/usr/bin/env python
"""Run monocular SLAM on EuRoC-layout sequences (single- or multi-agent).

Single agent:
    python examples/run_euroc.py --seq /data/euroc/MH_01_easy --out output/

Two agents as a centralized multi-agent run (the MAM3SLAM headline
configuration — each sequence is one agent, frames fed INTERLEAVED so both
agents track concurrently like the reference's per-agent threads
(src/Agent.cc:92-113); maps merge when they overlap):
    python examples/run_euroc.py --seq MH_01_easy --seq MH_02_easy --out output/

Sequences rendered by examples/make_rendered_dataset.py carry their own
mav0/cam0/sensor.yaml calibration; real EuRoC sequences fall back to the
published cam0 factory calibration.

Writes the reference artifact set (Trajectory_i.txt, KF_traj.txt,
MapLogs.txt, Times*.txt, map.png) plus ATE.txt when ground truth is
available.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_yaml(c, n_features, n_levels=8):
    if c.get("model") == "kb8":
        cam_block = f"""Camera.type: "KannalaBrandt8"
Camera1.fx: {c['fx']}
Camera1.fy: {c['fy']}
Camera1.cx: {c['cx']}
Camera1.cy: {c['cy']}
Camera1.k1: {c['dist'][0]}
Camera1.k2: {c['dist'][1]}
Camera1.k3: {c['dist'][2]}
Camera1.k4: {c['dist'][3]}"""
    else:
        cam_block = f"""Camera.type: "PinHole"
Camera1.fx: {c['fx']}
Camera1.fy: {c['fy']}
Camera1.cx: {c['cx']}
Camera1.cy: {c['cy']}
Camera1.k1: {c['dist'][0]}
Camera1.k2: {c['dist'][1]}
Camera1.p1: {c['dist'][2]}
Camera1.p2: {c['dist'][3]}"""
    return f"""%YAML:1.0
File.version: "1.0"
{cam_block}
Camera.width: {c['width']}
Camera.height: {c['height']}
Camera.fps: {c['fps']}
Camera.RGB: 1
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="append", required=True,
                    help="EuRoC sequence dir (repeat for multi-agent)")
    ap.add_argument("--out", default="output")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--n-features", type=int, default=1000)
    ap.add_argument("--n-levels", type=int, default=8)
    ap.add_argument("--kf-max-interval", type=int, default=None,
                    help="max frames between keyframes (SlamConfig "
                    "default otherwise)")
    ap.add_argument("--serial", action="store_true",
                    help="feed agents one after another instead of "
                    "interleaved (not the reference behavior)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run mapping/server on the worker thread")
    ap.add_argument("--frames-png", type=int, default=0, metavar="N",
                    help="write an annotated tracking frame (FrameDrawer "
                    "analog) every N frames to OUT/frames_<agent>/")
    args = ap.parse_args()

    if os.environ.get("MAM3_FORCE_CPU"):
        # run on the CPU even where a GPU is present
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        from mam3slam_tpu.utils import compile_cache
        compile_cache.enable()

    from mam3slam_tpu import api
    from mam3slam_tpu.io import euroc, viewer, writers

    os.makedirs(args.out, exist_ok=True)
    overrides = {}
    if args.kf_max_interval:
        overrides["kf_max_interval"] = args.kf_max_interval
    mas = api.MultiAgentSystem(async_mapping=args.async_mapping,
                               slam_overrides=overrides)
    agents = []
    for i, seq in enumerate(args.seq):
        c = euroc.load_sensor_yaml(seq) or euroc.EUROC_CAM0
        yaml_path = os.path.join(args.out, f"cam_{i}.yaml")
        with open(yaml_path, "w") as f:
            f.write(make_yaml(c, args.n_features, args.n_levels))
        agents.append(mas.add_agent(yaml_path))

    def dump_frame(aid, img, i):
        """Annotated tracking frame (reference FrameDrawer,
        src/FrameDrawer.cc) every --frames-png frames."""
        if not args.frames_png or i % args.frames_png:
            return
        d = os.path.join(args.out, f"frames_{aid}")
        os.makedirs(d, exist_ok=True)
        viewer.render_tracking_frame(mas.sys, aid, img,
                                     os.path.join(d, f"{i:06d}.png"))

    if args.serial:
        for aid, seq in zip(agents, args.seq):
            print(f"agent {aid}: {seq}")
            for i, (ts, img) in enumerate(
                    euroc.frames(seq, max_frames=args.max_frames)):
                state, pose = mas.track_monocular(aid, img, ts)
                dump_frame(aid, img, i)
                if i % 100 == 0:
                    print(f"  frame {i}  state={state}", flush=True)
    else:
        # interleaved: one frame per agent per round (concurrent tracking,
        # merges happen while every agent is live)
        iters = [iter(euroc.frames(seq, max_frames=args.max_frames))
                 for seq in args.seq]
        live = set(range(len(iters)))
        i = 0
        while live:
            for k in sorted(live):
                try:
                    ts, img = next(iters[k])
                except StopIteration:
                    live.discard(k)
                    continue
                state, pose = mas.track_monocular(agents[k], img, ts)
                dump_frame(agents[k], img, i)
                if i % 100 == 0:
                    maps = [a.map_id for a in mas.sys.agents]
                    print(f"round {i}  agent {agents[k]} state={state} "
                          f"maps={maps}", flush=True)
            i += 1

    mas.shutdown(out_dir=args.out)
    viewer.render_map(mas.sys, os.path.join(args.out, "map.png"),
                      server=mas.server)

    # ATE vs ground truth where available
    ate_rows = []
    for aid, seq in zip(agents, args.seq):
        try:
            gt = euroc.load_groundtruth(seq)
        except FileNotFoundError:
            continue
        traj = mas.sys.trajectory_world(aid)
        est, ref = [], []
        for ts, q, t, st in traj:
            if st != 2:
                continue
            j = np.searchsorted(gt[:, 0], ts)
            if 0 < j < len(gt):
                est.append(t)
                ref.append(gt[j, 1:4])
        if len(est) > 10:
            ate = writers.ate_rmse(np.asarray(est), np.asarray(ref))
            span = float(np.ptp(np.asarray(ref), axis=0).max())
            line = (f"agent {aid} ATE RMSE (Sim3-aligned): {ate:.4f} m "
                    f"over {len(est)} frames; span {span:.2f} m "
                    f"({100 * ate / span:.2f}%)")
            print(line)
            ate_rows.append(line)
    if ate_rows:
        with open(os.path.join(args.out, "ATE.txt"), "w") as f:
            f.write("\n".join(ate_rows) + "\n")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Live multi-agent SLAM daemon: frames arrive across a process boundary
(TCP or a watched directory), tracking runs on the freshest frame per
agent (reference ImageGrabber slot semantics,
/root/reference/Examples/ROS/MAM3SLAM/nodes/ros_mono_multi.cc:93-122),
and an MJPEG live view serves the annotated tracking window of every
agent (reference AgentViewer, src/AgentViewer.cc:21-45) to any browser.

TCP ingest + live view for two agents:
    python examples/run_daemon.py --settings cam0.yaml --settings cam1.yaml \
        --port 7700 --live-port 8080 --out output/
    # feed frames from any process:
    #   from mam3slam_tpu.io.daemon import send_frame
    #   sock = socket.create_connection(("127.0.0.1", 7700))
    #   send_frame(sock, agent=0, ts=..., image=gray_uint8)
    # watch live:  http://127.0.0.1:8080/

Directory ingest (a robot writing agent<k>_<ts>.png to shared storage):
    python examples/run_daemon.py --settings cam0.yaml --watch /tmp/frames

Self-contained demo (synthetic camera process feeding the daemon):
    python examples/run_daemon.py --demo --cpu
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", action="append", default=[],
                    help="per-agent settings YAML (repeat for multi-agent)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP ingest port (0 = auto)")
    ap.add_argument("--watch", default=None,
                    help="ingest agent<k>_<ts>.png files from this dir")
    ap.add_argument("--live-port", type=int, default=None,
                    help="serve MJPEG live view on this port")
    ap.add_argument("--out", default="output_daemon")
    ap.add_argument("--idle-exit-s", type=float, default=None,
                    help="exit after this long without any frame")
    ap.add_argument("--demo", action="store_true",
                    help="self-contained demo: spawn a synthetic camera "
                         "client process feeding the daemon over TCP")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        from mam3slam_tpu.utils import compile_cache
        compile_cache.enable()

    from mam3slam_tpu import api
    from mam3slam_tpu.io import viewer
    from mam3slam_tpu.io.daemon import (FrameIngestServer, MjpegServer,
                                        watch_directory)
    from mam3slam_tpu.io.stream import LatestFrameBuffer

    demo_dir = None
    if args.demo and not args.settings:
        import tempfile

        from mam3slam_tpu.io import render
        demo_dir = tempfile.mkdtemp(prefix="mam3_daemon_demo")
        cam = render.RenderCam(width=320, height=240, fx=160.0, fy=160.0,
                               cx=160.0, cy=120.0)
        yaml_path = os.path.join(demo_dir, "cam.yaml")
        with open(yaml_path, "w") as f:
            f.write(f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {cam.fx}
Camera1.fy: {cam.fy}
Camera1.cx: {cam.cx}
Camera1.cy: {cam.cy}
Camera1.k1: 0.0
Camera1.k2: 0.0
Camera1.p1: 0.0
Camera1.p2: 0.0
Camera.width: {cam.width}
Camera.height: {cam.height}
Camera.fps: 20
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
        args.settings = [yaml_path]
        args.idle_exit_s = args.idle_exit_s or 5.0
        if args.live_port is None:
            args.live_port = 0  # auto port: the demo serves / and /map

    mas = api.MultiAgentSystem()
    buffers = {}
    for yaml_path in args.settings:
        aid = mas.add_agent(yaml_path)
        buffers[aid] = LatestFrameBuffer()

    ingest = None
    if args.watch:
        os.makedirs(args.watch, exist_ok=True)
        watch_directory(args.watch, buffers)
        print(f"watching {args.watch} for agent<k>_<ts>.png", flush=True)
    else:
        ingest = FrameIngestServer(buffers, port=args.port)
        print(f"TCP ingest on 127.0.0.1:{ingest.port}", flush=True)

    live = None
    map_stop = threading.Event()
    if args.live_port is not None:
        live = MjpegServer(port=args.live_port)
        print(f"live view on http://127.0.0.1:{live.port}/ "
              f"(per-agent tracking; 3D map on /map, interactive "
              f"rotate/zoom on /map3d)", flush=True)

        def map_view_loop():
            # live 3D map (reference MapDrawer window) re-rendered at
            # ~1 Hz from the current functional MapState snapshot; the
            # JSON snapshot feeds the interactive /map3d browser viewer
            while not map_stop.is_set():
                try:
                    live.publish("map", viewer.draw_map_image(
                        mas.sys, server=mas.server, max_points=4000))
                    live.publish_json("map", viewer.map_snapshot(
                        mas.sys, server=mas.server, max_points=4000))
                except Exception:
                    pass
                map_stop.wait(1.0)

        map_thread = threading.Thread(target=map_view_loop, daemon=True)
        map_thread.start()

    if args.demo:
        def camera_client():
            import socket as _socket

            from mam3slam_tpu.io import render
            from mam3slam_tpu.io.daemon import send_frame
            scene = render.RoomScene(seed=1)
            cam = render.RenderCam(width=320, height=240, fx=160.0,
                                   fy=160.0, cx=160.0, cy=120.0)
            # slow orbit at ~7 fps: the first frames are dropped while
            # the daemon compiles, then tracking keeps up and the live
            # view shows the annotated window advancing
            traj = render.orbit_trajectory(300, 0.0, 240.0, radius=2.5,
                                           bob=0.05)
            sock = _socket.create_connection(("127.0.0.1", ingest.port))
            for i, (R, t, C, q) in enumerate(traj):
                img = scene.render(R, t, cam)
                send_frame(sock, 0, i / 20.0, img)
                time.sleep(0.15)
            sock.close()

        threading.Thread(target=camera_client, daemon=True).start()

    # tracking loop: freshest frame per agent, round-robin
    n_tracked = {aid: 0 for aid in buffers}
    last_frame_t = time.time()
    try:
        while True:
            any_frame = False
            for aid, buf in buffers.items():
                item = buf.take(timeout_s=0.05)
                if item is None:
                    continue
                any_frame = True
                last_frame_t = time.time()
                ts, img = item
                st, _ = mas.track_monocular(aid, img, ts)
                n_tracked[aid] += 1
                if live is not None:
                    live.publish(aid, viewer.draw_tracking_frame(
                        mas.sys, aid, np.asarray(img, np.float32)))
            if not any_frame:
                if all(b.closed for b in buffers.values()):
                    break
                if (args.idle_exit_s is not None
                        and time.time() - last_frame_t > args.idle_exit_s):
                    break
    except KeyboardInterrupt:
        pass

    os.makedirs(args.out, exist_ok=True)
    from mam3slam_tpu.io import writers
    writers.save_all(mas.sys, mas.server, args.out)
    for aid, buf in buffers.items():
        print(f"agent {aid}: tracked {n_tracked[aid]} "
              f"(pushed {buf.n_pushed}, dropped {buf.n_dropped}) "
              f"state={mas.sys.agents[aid].state}")
    map_stop.set()
    if args.live_port is not None:
        # join so the renderer isn't mid-native-call (jax/matplotlib)
        # when the interpreter tears down — a C++ thread killed there
        # aborts with "FATAL: exception not rethrown"
        map_thread.join(timeout=5.0)
    if ingest is not None:
        ingest.close()
    if live is not None:
        live.close()
    print(f"artifacts -> {args.out}")


if __name__ == "__main__":
    main()

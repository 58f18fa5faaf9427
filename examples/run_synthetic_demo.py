#!/usr/bin/env python
"""Self-contained demo: two agents map a synthetic scene, the centralized
server fuses their maps, artifacts + a map render are written to --out.

    python examples/run_synthetic_demo.py --out /tmp/demo
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/mam3slam_demo")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: JAX's default "
                         "device, a GPU where there is one)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        from mam3slam_tpu.utils import compile_cache
        compile_cache.enable()

    import numpy as np

    from mam3slam_tpu.geometry import cameras
    from mam3slam_tpu.io import viewer, writers
    from mam3slam_tpu.slam.server import LoopServer, ServerConfig
    from mam3slam_tpu.slam.system import SlamConfig, SlamSystem
    from test_slam_e2e import (FX, FY, CX, CY, H, N_FEAT, W, SyntheticWorld)
    from test_server_merge import arc_trajectory

    world = SyntheticWorld(n_mp=1200, seed=1)
    cam = cameras.make_pinhole(FX, FY, CX, CY)
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=96,
                     max_mp=6144, n_levels=4, kf_max_interval=10,
                     min_init_matches=60)
    sys_ = SlamSystem(cfg, cam)
    a0 = sys_.add_agent()
    a1 = sys_.add_agent()
    srv = LoopServer(sys_, ServerConfig(min_kfs_in_map=4, vocab_k=8,
                                        vocab_depth=3))
    sys_.server = srv

    trajs = [arc_trajectory(args.frames, start_x=0.0),
             arc_trajectory(args.frames, start_x=1.1)]
    t = 0.0
    for aid, traj in zip([a0, a1], trajs):
        for R, tt in traj:
            f, _ = world.render(R, tt)
            sys_.track(aid, f, t)
            t += 1.0
        print(f"agent {aid}: state={sys_.agents[aid].state} "
              f"map={sys_.agents[aid].map_id}")

    print("server events:", srv.events)
    os.makedirs(args.out, exist_ok=True)
    writers.save_all(sys_, srv, args.out)
    viewer.render_map(sys_, os.path.join(args.out, "map.png"), server=srv)
    n_kf = int(np.asarray(sys_.ms.kf_valid).sum())
    n_mp = int(np.asarray(sys_.ms.mp_valid).sum())
    print(f"done: {n_kf} keyframes, {n_mp} map points -> {args.out}")


if __name__ == "__main__":
    main()

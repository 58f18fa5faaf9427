#!/usr/bin/env python3
"""Drive the multi-agent SLAM path once on one GPU and check what comes out.

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-gpus   # four GPUs: distributed GBA only

Refuses to run anywhere but on a GPU (exit 1, no result line); never falls
back to the CPU.  The only CPU work is the explicit reference runs of
phase 2 on ``jax.devices("cpu")``.  Everything runs in this one process;
the host renderer's worker processes never touch the card.

Set-up builds ``native/*.so`` with ``native/build.sh`` and turns on the
persistent compile cache (``mam3slam_tpu.utils.compile_cache``).

Phases, each one JSON line (``"phase": n``):

1. Device: JAX platform / device kind / count, and the card's name and
   power limit from ``nvidia-smi`` (a subprocess that does not import JAX).
2. Program parity at the reference fixture's sizes (960x960 KB8, 8 levels
   x1.2, 700 features; the api's default arena): each of the ORB front
   end, the tracking step, the mapping epoch and the server's BoW
   quantise/detect, Sim3 RANSAC+GN, essential-graph PGO and conditional
   GBA is compiled for the GPU (compile seconds, ``memory_analysis()``),
   run on the GPU and on the CPU device on the same inputs -- captured
   while phases 3-4 ran, which is why this phase runs after them -- and
   compared under a stated tolerance, once with default matmul precision
   and once under ``jax.default_matmul_precision("highest")``.
3. Two KB8 agents at the fixture camera on overlapping arcs of the
   rendered room, fed interleaved through ``api.MultiAgentSystem``: OK
   share after initialisation >= 0.95 each, a server MERGE, ATE < 1% of
   the span each.
4. One pinhole agent, 752x480, 4 levels, on a loop-closing orbit: LOOP,
   PGO and GBA, ATE < 1% of the span.  Tracking runs the pose kernel.
5. Kernel A/B: each hand-written kernel against its plain XLA form at the
   shapes of phases 3-4 (warm, ``block_until_ready``, median of >= 20
   runs; compile seconds apart), alone and inside the tracking step.

``--four-gpus`` runs only ``dist_window_ba.dist_global_ba`` over a flat
4-GPU mesh on a 256-KF / 16,384-point / 131k-edge map and compares it
with the single-device ``run_window_ba_dense`` GBA on the same state.

The last line is ``{"ok": true, "device": {...}}`` and nothing else; any
failed phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------

FULL = dict(
    # phase 3: the reference fixture (test/settingsForTest_00.yaml)
    kb8_scale=1.0, kb8_levels=8, kb8_features=700, kb8_frames=130,
    # phase 4: EuRoC's camera shape, 4 levels; 450 deg so the revisit
    # spans several keyframes (the 3-keyframe loop confirmation needs
    # them)
    pin_w=752, pin_h=480, pin_levels=4, pin_features=700, pin_frames=290,
    pin_arc=450.0,
    # timing
    reps=30,
    # SlamConfig overrides on top of the api's default arena
    slam=dict(min_init_matches=80, kf_max_interval=8),
)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}, default=_json_default),
          flush=True)


def _json_default(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def require_gpu():
    """Exit non-zero unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {backend!r}")
    return jax.devices()


def build_native() -> dict:
    """Build native/*.so; report the build and which vocabulary trainer
    ``bow.build_vocabulary`` will run (native when the library loads)."""
    r = subprocess.run(["bash", os.path.join(HERE, "native", "build.sh")],
                       capture_output=True, text=True, timeout=600)
    from mam3slam_tpu.ops import bow

    return {"native_build": r.returncode == 0,
            "native_build_log": (r.stdout + r.stderr).strip()[-400:],
            "vocab_trainer": ("native" if bow._load_native() is not None
                              else "numpy")}


def yaml_for(cam, n_levels: int, n_features: int) -> str:
    """Settings file text (reference FileStorage dialect) for a RenderCam."""
    lines = ["%YAML:1.0", 'File.version: "1.0"']
    if cam.model == "kb8":
        lines.append('Camera.type: "KannalaBrandt8"')
    else:
        lines.append('Camera.type: "PinHole"')
    lines += [f"Camera1.fx: {cam.fx}", f"Camera1.fy: {cam.fy}",
              f"Camera1.cx: {cam.cx}", f"Camera1.cy: {cam.cy}"]
    if cam.model == "kb8":
        lines += [f"Camera1.k{i + 1}: {k}" for i, k in enumerate(cam.k)]
    lines += [f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
              "Camera.fps: 20", "Camera.RGB: 1",
              f"ORBextractor.nFeatures: {n_features}",
              "ORBextractor.scaleFactor: 1.2",
              f"ORBextractor.nLevels: {n_levels}",
              "ORBextractor.iniThFAST: 20", "ORBextractor.minThFAST: 7"]
    return "\n".join(lines) + "\n"


_SCENES = {}


def _render_one(job):
    """Worker: one frame as float16 (numpy only; never imports JAX)."""
    from mam3slam_tpu.io import render

    seed, cam, R, t = job
    if seed not in _SCENES:
        _SCENES[seed] = render.RoomScene(seed=seed)
    return _SCENES[seed].render(R, t, cam).astype(np.float16)


def render_frames(seed, traj, cam, workers: int) -> np.ndarray:
    """Render a trajectory on host worker processes (spawned, so they
    share no state with this JAX process and never open the card)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    jobs = [(seed, cam, R, t) for (R, t, _, _) in traj]
    if workers <= 1:
        return np.stack([_render_one(j) for j in jobs])
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as ex:
        return np.stack(list(ex.map(_render_one, jobs, chunksize=4)))


def ate_span(mas, aid, traj):
    """ATE (Sim3-aligned RMSE) over OK frames, and the trajectory span."""
    from mam3slam_tpu.io import writers
    from mam3slam_tpu.slam.system import OK

    est, ref = [], []
    for (ts, q, t, st), (_, _, C, _) in zip(mas.sys.trajectory_world(aid),
                                             traj):
        if st == OK:
            est.append(t)
            ref.append(C)
    if len(est) < 3:
        return float("inf"), 0.0, len(est)
    span = float(np.ptp(np.asarray(ref), axis=0).max())
    return writers.ate_rmse(np.asarray(est), np.asarray(ref)), span, len(est)


def ok_share(states):
    from mam3slam_tpu.slam.system import OK

    if OK not in states:
        return 0.0
    first = states.index(OK)
    return float(np.mean([s == OK for s in states[first:]]))


# ---------------------------------------------------------------------------
# capture + replay (phase 2)
# ---------------------------------------------------------------------------

class Capture:
    """Records the arguments of one call of each named program while the
    system runs, so phase 2 can replay exactly those inputs."""

    def __init__(self):
        self.calls = {}
        self._patches = []

    def wrap(self, name, fn, at: int = 0):
        import jax

        count = [0]

        def wrapped(*args, **kwargs):
            if name not in self.calls and count[0] >= at:
                self.calls[name] = (fn, jax.device_get((args, kwargs)))
            count[0] += 1
            return fn(*args, **kwargs)

        return wrapped

    def patch(self, owner, attr, name, at: int = 0):
        """Wrap ``owner.attr`` (a module attribute) or ``owner[attr]``."""
        if isinstance(owner, (dict, list)):
            orig = owner[attr]
            owner[attr] = self.wrap(name, orig, at)
        else:
            orig = getattr(owner, attr)
            setattr(owner, attr, self.wrap(name, orig, at))
        self._patches.append((owner, attr, orig))

    def restore(self):
        for owner, attr, orig in reversed(self._patches):
            if isinstance(owner, (dict, list)):
                owner[attr] = orig
            else:
                setattr(owner, attr, orig)
        self._patches = []


def replay(fn, args, kwargs, device, precision=None):
    """Compile ``fn`` on the captured inputs for ``device`` and run it.
    Array leaves are inputs; every other leaf (ints, camera kinds, static
    sizes) stays a Python constant.  Returns (host output, compile s,
    memory analysis dict)."""
    import jax

    leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
    dyn = [i for i, x in enumerate(leaves) if isinstance(x, np.ndarray)]

    def program(*xs):
        full = list(leaves)
        for i, x in zip(dyn, xs):
            full[i] = x
        a, k = jax.tree_util.tree_unflatten(tree, full)
        return fn(*a, **k)

    xs = [jax.device_put(leaves[i], device) for i in dyn]
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        compiled = jax.jit(program).lower(*xs).compile()
        compile_s = time.perf_counter() - t0
    out = jax.device_get(compiled(*xs))
    return out, compile_s, memory_dict(compiled)


def memory_dict(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def _angles(qa, qb):
    qa = np.asarray(qa, np.float64).reshape(-1, 4)
    qb = np.asarray(qb, np.float64).reshape(-1, 4)
    d = np.abs(np.sum(qa * qb, axis=1)) / np.maximum(
        np.linalg.norm(qa, axis=1) * np.linalg.norm(qb, axis=1), 1e-30)
    return 2.0 * np.arccos(np.clip(d, 0.0, 1.0))


def _max(x):
    x = np.asarray(x, np.float64).ravel()
    return float(x.max()) if x.size else 0.0


def _hamming(a, b):
    return np.unpackbits(np.asarray(a, np.uint8) ^ np.asarray(b, np.uint8),
                         axis=-1).sum(-1)


# Tolerances (GPU result vs the CPU device's, same inputs), with reasons.
TOL = {
    "features": (
        {"kp_same_frac_min": 0.97, "hamming_mean_max": 0.5,
         "hamming_max_max": 16},
        "a keypoint moves only where two FAST scores or two cell "
        "candidates tie to float32 rounding (sums taken in another order); "
        "a rotated BRIEF tap flips only where the IC angle lands on a "
        "rounding edge"),
    "poses": (
        {"angle_rad_max": 2e-3, "trans_max": 2e-3},
        "LM on float32 normal equations in another summation order "
        "converges to the same minimum within ~1e-4; the bound leaves "
        "room for one accept/reject step decided differently near a tie "
        "(translation in map units: monocular scale, scene depth ~1)"),
    "points": (
        {"median_max": 1e-3, "p99_max": 5e-2, "valid_mismatch_frac_max":
         0.01},
        "well-observed points agree to ~1e-5; a few poorly constrained "
        "points slide along their viewing rays, and a point at a culling "
        "threshold may be kept on one device and dropped on the other "
        "(map units)"),
    "exact": (
        {"equal_frac_min": 1.0},
        "integer Hamming arithmetic (bf16 bit matmuls are exact): the "
        "device must not matter"),
    "scores": (
        {"equal_frac_min": 0.99, "rel_max": 1e-4},
        "BoW L1 scores are float32 sums in another order; candidate "
        "ranks swap only on exact ties"),
}


def _check(metrics: dict, tol: dict) -> bool:
    ok = True
    for k, bound in tol.items():
        name, kind = k.rsplit("_", 1)
        v = metrics.get(name)
        if v is None:
            continue
        ok &= (v >= bound) if kind == "min" else (v <= bound)
    return bool(ok)


def cmp_features(g, c):
    same = (np.asarray(g.valid) & np.asarray(c.valid)
            & np.all(np.asarray(g.xy) == np.asarray(c.xy), axis=1)
            & (np.asarray(g.level) == np.asarray(c.level)))
    ham = _hamming(g.desc, c.desc)[same]
    return {"features": {
        "kp_same_frac": float(same.sum() / max(np.asarray(c.valid).sum(), 1)),
        "hamming_mean": float(ham.mean()) if ham.size else 0.0,
        "hamming_max": int(ham.max()) if ham.size else 0}}


def cmp_poses(qa, ta, qb, tb, mask=None):
    qa, qb = np.asarray(qa).reshape(-1, 4), np.asarray(qb).reshape(-1, 4)
    ta, tb = np.asarray(ta).reshape(-1, 3), np.asarray(tb).reshape(-1, 3)
    m = np.ones(len(qa), bool) if mask is None else np.asarray(mask)
    return {"poses": {"angle_rad": _max(_angles(qa[m], qb[m])),
                      "trans": _max(np.linalg.norm(ta[m] - tb[m], axis=1))}}


def cmp_mapstate(g, c):
    kf = np.asarray(g.kf_valid) & np.asarray(c.kf_valid)
    out = cmp_poses(g.kf_q, g.kf_t, c.kf_q, c.kf_t, kf)
    vg, vc = np.asarray(g.mp_valid), np.asarray(c.mp_valid)
    both = vg & vc
    d = np.linalg.norm(np.asarray(g.mp_pos)[both] - np.asarray(c.mp_pos)[both],
                       axis=1)
    out["points"] = {
        "median": float(np.median(d)) if d.size else 0.0,
        "p99": float(np.percentile(d, 99)) if d.size else 0.0,
        "valid_mismatch_frac": float((vg ^ vc).sum() / max(vc.sum(), 1))}
    return out


def cmp_track(g, c):
    vg, vc = np.asarray(g[4]), np.asarray(c[4])
    out = cmp_poses(vg[0:4], vg[4:7], vc[0:4], vc[4:7])
    out["points"] = None
    return out


def cmp_equal(g, c):
    g, c = np.asarray(g), np.asarray(c)
    return {"exact": {"equal_frac": float(np.mean(g == c))}}


def cmp_detect(g, c):
    reps = np.mean(np.asarray(g[0]) == np.asarray(c[0]))
    ag, ac = np.asarray(g[1], np.float64), np.asarray(c[1], np.float64)
    rel = np.abs(ag - ac) / np.maximum(np.abs(ac), 1e-6)
    return {"scores": {"equal_frac": float(reps), "rel": _max(rel)}}


def cmp_sim3(g, c):
    def parts(r):
        if hasattr(r, "q"):
            return r.q, r.t, r.s
        return r[0], r[1], r[2]
    qg, tg, sg = parts(g)
    qc, tc, sc = parts(c)
    out = cmp_poses(qg, tg, qc, tc)
    out["poses"]["scale_rel"] = float(abs(float(sg) - float(sc))
                                      / max(abs(float(sc)), 1e-9))
    return out


def cmp_pgo(g, c):
    out = cmp_poses(g[0], g[1], c[0], c[1])
    out["poses"]["scale_rel"] = _max(
        np.abs(np.asarray(g[2]) - np.asarray(c[2]))
        / np.maximum(np.abs(np.asarray(c[2])), 1e-9))
    return out


PROGRAMS = [
    # (capture name, comparison)
    ("extract", cmp_features),
    ("track_frame_step", cmp_track),
    ("mapping_epoch", lambda g, c: cmp_mapstate(g[0], c[0])),
    ("bow_quantize", cmp_equal),
    ("bow_detect", cmp_detect),
    ("sim3_ransac", cmp_sim3),
    ("sim3_gn", cmp_sim3),
    ("pgo_essential_graph", cmp_pgo),
    ("global_ba", cmp_mapstate),
]


def phase2(cap: Capture, dev, cpu) -> dict:
    """Replay every captured program on ``dev`` and on ``cpu``."""
    results, all_ok = [], True
    for name, compare in PROGRAMS:
        if name not in cap.calls:
            results.append({"program": name, "ok": False,
                            "error": "not captured"})
            all_ok = False
            continue
        fn, (args, kwargs) = cap.calls[name]
        ref, cpu_s, _ = replay(fn, args, kwargs, cpu)
        entry = {"program": name, "cpu_compile_s": round(cpu_s, 3),
                 "runs": []}
        for prec in ("default", "highest"):
            out, gpu_s, mem = replay(fn, args, kwargs, dev,
                                     None if prec == "default" else prec)
            metrics = {k: v for k, v in compare(out, ref).items()
                       if v is not None}
            ok = all(_check(m, TOL[k][0]) for k, m in metrics.items())
            entry["runs"].append({"precision": prec, "ok": ok,
                                  "compile_s": round(gpu_s, 3),
                                  "memory": mem, "metrics": metrics})
        entry["ok"] = all(r["ok"] for r in entry["runs"])
        entry["tol"] = {k: TOL[k][0] for k in metrics}
        entry["why"] = {k: TOL[k][1] for k in metrics}
        all_ok &= entry["ok"]
        results.append(entry)
    return {"ok": all_ok, "programs": results}


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def install_captures(cap: Capture, mas):
    """Capture inputs of the system's and the server's programs while the
    system runs (the ``at``-th call of each, once the map has content)."""
    from mam3slam_tpu.ops import bow
    from mam3slam_tpu.solvers import pgo, sim3

    cap.patch(mas._extract_fns, 0, "extract", at=20)
    cap.patch(mas.sys.fns, "track_frame_step", "track_frame_step", at=40)
    cap.patch(mas.sys.fns, "mapping_epoch", "mapping_epoch", at=4)
    cap.patch(bow, "quantize", "bow_quantize", at=16)
    cap.patch(bow, "detect_candidates_grouped", "bow_detect", at=4)
    cap.patch(sim3, "ransac_sim3", "sim3_ransac")
    cap.patch(sim3, "optimize_sim3", "sim3_gn")
    cap.patch(pgo, "optimize_essential_graph", "pgo_essential_graph")
    cap.patch(mas.sys.fns, "global_ba", "global_ba")


def phase3(sz: dict, cap: Capture, workdir: str, workers: int) -> dict:
    """Two KB8 agents, fixture camera, overlapping arcs, interleaved."""
    from mam3slam_tpu import api
    from mam3slam_tpu.io import render
    from mam3slam_tpu.ops import bow

    cam = render.reference_kb8_cam(scale=sz["kb8_scale"])
    N = sz["kb8_frames"]
    traj = [render.orbit_trajectory(N, 0.0, 190.0, radius=2.5, bob=0.05),
            render.orbit_trajectory(N, 170.0, 360.0, radius=2.5, bob=0.05)]
    t0 = time.perf_counter()
    frames = [render_frames(5, tr, cam, workers) for tr in traj]
    render_s = time.perf_counter() - t0

    path = os.path.join(workdir, "kb8.yaml")
    with open(path, "w") as f:
        f.write(yaml_for(cam, sz["kb8_levels"], sz["kb8_features"]))
    mas = api.MultiAgentSystem(slam_overrides=sz["slam"])
    aids = [mas.add_agent(path), mas.add_agent(path)]
    install_captures(cap, mas)
    states = {a: [] for a in aids}
    frame_s = []
    t0 = time.perf_counter()
    for i in range(N):
        for a in aids:
            f0 = time.perf_counter()
            st, _ = mas.track_monocular(a, frames[a][i], i / 20.0)
            frame_s.append(time.perf_counter() - f0)
            states[a].append(st)
    mas.shutdown()
    wall = time.perf_counter() - t0

    merges = [e for e in mas.server.events if e.startswith("MERGE")]
    agents = []
    ok = bool(merges)
    for a, tr in zip(aids, traj):
        ate, span, n_ok = ate_span(mas, a, tr)
        share = ok_share(states[a])
        a_ok = share >= 0.95 and ate < 0.01 * span
        ok &= a_ok
        agents.append({"agent": a, "ok_share": round(share, 4),
                       "ate": ate, "span": span,
                       "ate_over_span": ate / span if span else None,
                       "n_ok_frames": n_ok, "ok": a_ok})
    return {"ok": ok, "frames_per_agent": N, "camera": "kb8",
            "size": [cam.width, cam.height], "levels": sz["kb8_levels"],
            "features": sz["kb8_features"], "merge": merges[:2],
            "events": mas.server.events[:6], "agents": agents,
            "render_s": round(render_s, 2), "run_wall_s": round(wall, 2),
            "frame_ms_median": float(np.median(frame_s) * 1e3),
            "frame_ms_p90": float(np.percentile(frame_s, 90) * 1e3),
            "gba_runs": list(mas.server.gba_runs),
            "vocab_trainer": ("native" if bow._load_native() is not None
                              else "numpy")}


def phase4(sz: dict, cap: Capture, workdir: str, workers: int) -> dict:
    """One pinhole agent (EuRoC's camera shape) on a loop-closing orbit;
    captures a tracking step for phase 5."""
    from mam3slam_tpu import api
    from mam3slam_tpu.io import render

    W, H = sz["pin_w"], sz["pin_h"]
    cam = render.RenderCam(width=W, height=H, fx=W / 2.0, fy=W / 2.0,
                           cx=W / 2.0, cy=H / 2.0)
    N = sz["pin_frames"]
    traj = render.orbit_trajectory(N, 0.0, sz["pin_arc"], radius=2.5,
                                   bob=0.05)
    t0 = time.perf_counter()
    frames = render_frames(3, traj, cam, workers)
    render_s = time.perf_counter() - t0

    path = os.path.join(workdir, "pinhole.yaml")
    with open(path, "w") as f:
        f.write(yaml_for(cam, sz["pin_levels"], sz["pin_features"]))
    mas = api.MultiAgentSystem(slam_overrides=sz["slam"])
    aid = mas.add_agent(path)
    cap.patch(mas.sys.fns, "track_frame_step", "track_frame_step_pinhole",
              at=60)
    states, frame_s = [], []
    t0 = time.perf_counter()
    for i in range(N):
        f0 = time.perf_counter()
        st, _ = mas.track_monocular(aid, frames[i], i / 20.0)
        frame_s.append(time.perf_counter() - f0)
        states.append(st)
    mas.shutdown()
    wall = time.perf_counter() - t0
    ate, span, n_ok = ate_span(mas, aid, traj)
    share = ok_share(states)
    loops = [e for e in mas.server.events if e.startswith("LOOP")]
    pgo_ran = "pgo_essential_graph" in cap.calls or bool(loops)
    gba = list(mas.server.gba_runs)
    ok = bool(loops) and bool(gba) and ate < 0.01 * span
    return {"ok": ok, "frames": N, "camera": "pinhole", "size": [W, H],
            "levels": sz["pin_levels"], "features": sz["pin_features"],
            "ok_share": round(share, 4), "loop": loops[:2],
            "pgo": pgo_ran, "gba_runs": gba, "ate": ate, "span": span,
            "ate_over_span": ate / span if span else None,
            "n_ok_frames": n_ok, "events": mas.server.events[:6],
            "render_s": round(render_s, 2), "run_wall_s": round(wall, 2),
            "frame_ms_median": float(np.median(frame_s) * 1e3),
            "frame_ms_p90": float(np.percentile(frame_s, 90) * 1e3)}


# ---------------------------------------------------------------------------
# phase 5: kernel A/B
# ---------------------------------------------------------------------------

def time_compiled(fn, xs, reps: int):
    """(compile s, median run ms) of ``jax.jit(fn)`` on ``xs``: warm,
    each run ended by ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*xs).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*xs))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*xs))
        ts.append(time.perf_counter() - t0)
    return compile_s, float(np.median(ts) * 1e3)


def phase5(cap: Capture, dev, reps: int) -> dict:
    """The fused pose kernel against the XLA pose path: alone at the
    tracking step's width, and inside the captured tracking step."""
    import functools

    import jax

    from mam3slam_tpu.geometry import cameras as cam_mod
    from mam3slam_tpu.slam import steps
    from mam3slam_tpu.solvers import ba

    if "track_frame_step_pinhole" not in cap.calls:
        return {"ok": False, "error": "pinhole tracking step not captured"}
    step, (args, kwargs) = cap.calls["track_frame_step_pinhole"]
    ms, frame, cam_params = args[0], args[1], args[-1]
    # the pose problem the step's last stage solves: its matches, from
    # its predicted pose (vec[24:31] = q_pred, t_pred)
    out = jax.device_get(step(*jax.device_put(args, dev)))
    feat_mp, vec = np.asarray(out[1]), np.asarray(out[4])
    mp = np.clip(feat_mp, 0, None)
    pts = np.asarray(ms.mp_pos)[mp]
    w = (1.2 ** (-2.0 * np.asarray(frame.level))).astype(np.float32)
    valid = (feat_mp >= 0) & np.asarray(frame.valid) & np.asarray(
        ms.mp_valid)[mp]
    xs = [jax.device_put(x, dev) for x in
          (vec[24:28], vec[28:31], np.asarray(cam_params), pts,
           np.asarray(frame.uv), w, valid)]

    def pose(use_kernel):
        return lambda q, t, c, p, uv, w_, v: ba.pose_optimization(
            q, t, c, cam_mod.PINHOLE, p, uv, w_, v, use_kernel=use_kernel)

    res = {"n_slots": int(pts.shape[0]), "n_matched": int(valid.sum())}
    for label, use in (("kernel", True), ("xla", False)):
        c_s, ms_ = time_compiled(pose(use), xs, reps)
        res[f"pose_{label}_compile_s"] = round(c_s, 3)
        res[f"pose_{label}_ms"] = ms_
    rk = jax.device_get(jax.jit(pose(True))(*xs))
    rx = jax.device_get(jax.jit(pose(False))(*xs))
    res["pose_kernel_vs_xla_angle_rad"] = float(_angles(rk.q, rx.q)[0])
    res["pose_kernel_vs_xla_trans"] = float(
        np.linalg.norm(np.asarray(rk.t) - np.asarray(rx.t)))

    # end to end: the whole tracking step, kernel vs XLA pose path; a
    # fresh function object per variant so each traces anew
    dyn = jax.device_put(list(args), dev)
    inner = step.__wrapped__
    orig = steps.ba_mod.pose_optimization
    for label, use in (("kernel", True), ("xla", False)):
        steps.ba_mod.pose_optimization = functools.partial(orig,
                                                           use_kernel=use)
        try:
            c_s, ms_ = time_compiled(lambda *a: inner(*a), dyn, reps)
        finally:
            steps.ba_mod.pose_optimization = orig
        res[f"track_step_{label}_compile_s"] = round(c_s, 3)
        res[f"track_step_{label}_ms"] = ms_
    res["pose_speedup"] = res["pose_xla_ms"] / res["pose_kernel_ms"]
    res["track_step_speedup"] = (res["track_step_xla_ms"]
                                 / res["track_step_kernel_ms"])
    res["ok"] = bool(res["pose_kernel_vs_xla_angle_rad"] < 2e-3
                     and res["pose_kernel_vs_xla_trans"] < 2e-3)
    return res


# ---------------------------------------------------------------------------
# --four-gpus: distributed GBA vs single-device GBA
# ---------------------------------------------------------------------------

def four_gpus(devices, n_kf: int = 256, n_pt: int = 16384) -> dict:
    """``dist_global_ba`` over a flat mesh of the first four devices
    against the single-device dense GBA on the same map."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mam3slam_tpu.mapstate import state as S
    from mam3slam_tpu.parallel import dist_window_ba as dwb
    from mam3slam_tpu.slam import steps
    from mam3slam_tpu.solvers import ba_window as bw

    if len(devices) < 4:
        raise SystemExit(f"four-device path needs 4 devices, "
                         f"found {len(devices)}")
    ms, cfg = gba_arena(n_kf=n_kf, n_pt=n_pt)
    kind = cfg.cam_kind
    mesh = Mesh(np.array(devices[:4]), ("shard",))
    is2 = jnp.asarray(cfg.inv_sigma2)

    @jax.jit
    def build(ms):
        in_map = ms.kf_valid & (ms.kf_map == 0)
        anchor = jnp.argmin(jnp.where(in_map, ms.kf_seq, S.BIG_SEQ))
        return steps.build_window_problem(ms, in_map.at[anchor].set(False),
                                          is2, cfg.max_kf, cfg.max_mp,
                                          with_cm=False)

    prob = build(ms)
    n_edges = int(np.asarray(prob.pm_valid).sum())
    # iters=0: one pass that only evaluates the cost at the start
    cost0 = jax.jit(lambda p: bw.run_window_ba_dense(p, kind,
                                                     iters=0).cost)(prob)

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        return out, first, time.perf_counter() - t0

    # the solver on the mesh: the point-major edges are sharded 4 ways
    res_d, d_first, d_warm = timed(
        lambda p: dwb.dist_solve_window_ba(p, mesh, kind, iters=10), prob)
    spread, peaks = shards_spread(prob, devices[:4])
    # single device: the dense reduced-camera GBA
    res_s, s_first, s_warm = timed(
        jax.jit(lambda p: bw.run_window_ba_dense(p, kind, iters=10)), prob)
    # the user-facing epoch (ServerConfig.gba_mesh -> dist_global_ba)
    ms_d, g_first, g_warm = timed(
        lambda m: dwb.dist_global_ba(m, cfg, mesh, 0, kind), ms)

    cv = np.asarray(prob.cam_valid)
    pv = np.asarray(prob.pt_valid)
    poses = cmp_poses(res_d.cam_q, res_d.cam_t, res_s.cam_q, res_s.cam_t,
                      cv)["poses"]
    dp = np.linalg.norm(np.asarray(res_d.pts)[pv] - np.asarray(res_s.pts)[pv],
                        axis=1)
    cost_d, cost_s = float(res_d.cost), float(res_s.cost)
    cost_rel = abs(cost_d - cost_s) / max(abs(cost_s), 1e-9)
    ms_1 = steps.apply_window_result(ms, prob, res_s)
    epoch = cmp_poses(ms_d.kf_q, ms_d.kf_t, ms_1.kf_q, ms_1.kf_t,
                      np.asarray(ms.kf_valid))["poses"]
    tol = {"cost_rel_max": 0.02, "angle_rad_max": 5e-3, "trans_max": 1e-2}
    ok = (cost_rel <= tol["cost_rel_max"]
          and poses["angle_rad"] <= tol["angle_rad_max"]
          and poses["trans"] <= tol["trans_max"]
          and max(cost_d, cost_s) < float(cost0) and spread is not False
          and epoch["angle_rad"] <= tol["angle_rad_max"]
          and epoch["trans"] <= tol["trans_max"])
    return {"ok": bool(ok), "kfs": int(np.asarray(ms.kf_valid).sum()),
            "free_kfs": int(cv.sum()), "points": int(pv.sum()),
            "edges": n_edges, "mesh": [str(d) for d in devices[:4]],
            "peak_bytes_per_device": peaks, "shards_spread": spread,
            "cost_start": float(cost0), "cost_dist": cost_d,
            "cost_single": cost_s, "cost_rel": cost_rel,
            "pose_delta": poses,
            "point_delta_median": float(np.median(dp)) if dp.size else 0.0,
            "point_delta_p99": (float(np.percentile(dp, 99)) if dp.size
                                else 0.0),
            "epoch_vs_single_pose_delta": epoch, "tol": tol,
            "why": "the mesh solve runs preconditioned CG on the reduced "
                   "camera system where the single-device epoch factors "
                   "it exactly; both descend to the same basin, so costs "
                   "agree to a few per cent and poses to mrad",
            "dist_solve_first_s": round(d_first, 3),
            "dist_solve_warm_s": round(d_warm, 4),
            "single_solve_first_s": round(s_first, 3),
            "single_solve_warm_s": round(s_warm, 4),
            "dist_global_ba_first_s": round(g_first, 3),
            "dist_global_ba_warm_s": round(g_warm, 4)}


def shards_spread(prob, devices):
    """Did every device of the mesh hold its share of the edges?  Each
    device's peak memory must reach half of a quarter of the point-major
    edge arrays; a path that left every shard on device 0 fails.  Devices
    that report no memory statistics (the CPU) give ``None``."""
    stats = [d.memory_stats() for d in devices]
    if any(not st or "peak_bytes_in_use" not in st for st in stats):
        return None, None
    edge_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                     for name, x in prob._asdict().items()
                     if name.startswith("pm_"))
    peaks = [int(st["peak_bytes_in_use"]) for st in stats]
    return (min(peaks) >= 0.5 * edge_bytes / len(devices)), peaks


def gba_arena(n_kf: int, n_pt: int, seed: int = 0, obs_per_pt: int = 8):
    """A map of ``n_kf`` keyframes on an orbit inside a shell of ``n_pt``
    points, each point observed by ``obs_per_pt`` keyframes with pixel
    noise, poses and points perturbed: a GBA problem of known size."""
    import jax
    import jax.numpy as jnp

    from mam3slam_tpu.geometry import cameras, lie
    from mam3slam_tpu.mapstate import state as S
    from mam3slam_tpu.slam.system import SlamConfig

    rng = np.random.default_rng(seed)
    F = 768
    cfg = SlamConfig(width=752, height=480, n_feat=F, max_kf=n_kf,
                     max_mp=n_pt, n_levels=4)
    cam = cameras.make_pinhole(376.0, 376.0, 376.0, 240.0)
    th = rng.uniform(0, 2 * np.pi, n_pt)
    r = rng.uniform(4.0, 5.0, n_pt)
    pts = np.stack([r * np.cos(th), rng.uniform(-1.5, 1.5, n_pt),
                    r * np.sin(th)], axis=1).astype(np.float32)
    kf_ang = 2 * np.pi * np.arange(n_kf) / n_kf
    # each point is seen by the obs_per_pt keyframes nearest its bearing
    order = np.argsort(np.abs(((th[:, None] - kf_ang[None, :]) + np.pi)
                              % (2 * np.pi) - np.pi), axis=1)[:, :obs_per_pt]
    ms = S.init_map_state(cfg.map_config())
    ms = ms._replace(
        mp_pos=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape)
                           .astype(np.float32)),
        mp_valid=jnp.ones(n_pt, bool), mp_map=jnp.zeros(n_pt, jnp.int32),
        mp_desc=jnp.asarray(rng.integers(0, 256, (n_pt, 32), np.uint8)),
        mp_min_dist=jnp.full(n_pt, 0.1, jnp.float32),
        mp_max_dist=jnp.full(n_pt, 50.0, jnp.float32),
        map_valid=ms.map_valid.at[0].set(True))
    project = jax.jit(lambda Xc: cameras.project_ideal(cam, Xc))
    for k in range(n_kf):
        c, s = np.cos(kf_ang[k]), np.sin(kf_ang[k])
        C = np.array([2.5 * c, 0.0, 2.5 * s], np.float32)
        R = np.stack([np.array([s, 0.0, -c]), np.array([0.0, 1.0, 0.0]),
                      np.array([c, 0.0, s])]).astype(np.float32)
        t = (-R @ C).astype(np.float32)
        sel = np.flatnonzero((order == k).any(axis=1))[:F]
        uv = np.zeros((F, 2), np.float32)
        uv[:len(sel)] = np.asarray(project(jnp.asarray(pts[sel] @ R.T + t)))
        uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
        fvalid = np.arange(F) < len(sel)
        fmp = np.full(F, -1, np.int32)
        fmp[:len(sel)] = sel
        q = lie.quat_from_matrix(jnp.asarray(R))
        dt = rng.normal(0, 0.01, 3).astype(np.float32) if k else 0.0
        ms, _ = S.add_keyframe(
            ms, q, jnp.asarray(t + dt), jnp.asarray(0), jnp.asarray(0),
            jnp.asarray(float(k), jnp.float32), jnp.asarray(k),
            jnp.asarray(uv), jnp.zeros(F, jnp.int32),
            jnp.zeros(F, jnp.float32), jnp.zeros((F, 32), jnp.uint8),
            jnp.asarray(fvalid), jnp.asarray(fmp), cam_params=cam.params)
    ms = S.rebuild_reverse_obs(ms)
    return ms, cfg


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the distributed GBA over 4 GPUs and its "
                         "single-device comparison")
    ap.add_argument("--workers", type=int, default=8,
                    help="host processes rendering frames")
    args = ap.parse_args(argv)

    devices = require_gpu()
    import jax

    from mam3slam_tpu.utils import compile_cache

    t_start = time.perf_counter()
    dev = devices[0]
    emit(1, platform=dev.platform, device_kind=dev.device_kind,
         count=len(devices), nvidia_smi=nvidia_smi(),
         compile_cache=compile_cache.enable(), jax=jax.__version__)

    if args.four_gpus:
        r = four_gpus(devices)
        emit("four_gpus", **r)
        if not r["ok"] or r["shards_spread"] is not True:
            sys.exit("chip_smoke: four-GPU phase failed")
    else:
        emit("setup", **build_native())
        cap = Capture()
        cpu = jax.devices("cpu")[0]
        failed = []
        with tempfile.TemporaryDirectory() as workdir:
            r3 = phase3(FULL, cap, workdir, args.workers)
            emit(3, **r3)
            r4 = phase4(FULL, cap, workdir, args.workers)
            emit(4, **r4)
        cap.restore()
        r2 = phase2(cap, dev, cpu)
        emit(2, **r2)
        r5 = phase5(cap, dev, FULL["reps"])
        emit(5, **r5)
        for n, r in ((2, r2), (3, r3), (4, r4), (5, r5)):
            if not r["ok"]:
                failed.append(n)
        emit("summary", failed=failed,
             wall_s=round(time.perf_counter() - t_start, 1))
        if failed:
            sys.exit(f"chip_smoke: phases {failed} failed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()

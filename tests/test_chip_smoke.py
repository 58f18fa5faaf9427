"""chip_smoke.py on the CPU: its device gate refuses to run, and its phase
machinery (settings text, capture/replay, parity comparisons, the
four-device GBA comparison) works at a tiny size.  The phases themselves
run only on a GPU (``python chip_smoke.py``)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from mam3slam_tpu.io import render, settings  # noqa: E402
from mam3slam_tpu.ops import orb  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_device_gate_fails_on_cpu():
    r = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert r.stdout.strip() == ""  # no phase line, no result line
    assert "needs a GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("cam", [render.reference_kb8_cam(0.5),
                                 render.RenderCam(width=752, height=480)])
def test_settings_text_round_trips(tmp_path, cam):
    p = tmp_path / "cam.yaml"
    p.write_text(C.yaml_for(cam, 8, 700))
    st = settings.load_settings(str(p))
    assert (st.width, st.height) == (cam.width, cam.height)
    assert (st.n_levels, st.n_features) == (8, 700)
    assert st.fx == pytest.approx(cam.fx)
    assert st.camera().kind == (1 if cam.model == "kb8" else 0)


def test_capture_records_the_chosen_call():
    cap = C.Capture()
    box = {"f": lambda x, k=1: x * k}
    cap.patch(box, "f", "f", at=2)
    for i in range(4):
        box["f"](jnp.full(3, float(i)), k=2)
    fn, (args, kwargs) = cap.calls["f"]
    assert float(args[0][0]) == 2.0 and kwargs == {"k": 2}
    assert isinstance(args[0], np.ndarray)  # held on the host
    cap.restore()
    assert box["f"] is fn


def test_replay_keeps_static_leaves_static():
    def f(x, n, name="a"):
        assert isinstance(n, int) and name == "a"  # static at trace time
        return jnp.tile(x, n)

    cpu = jax.devices("cpu")[0]
    out, compile_s, mem = C.replay(f, (np.ones(2, np.float32), 3), {}, cpu)
    assert out.shape == (6,) and compile_s >= 0
    assert "temp_size_in_bytes" in mem


def test_phase2_on_two_cpu_devices():
    """Phase 2's machinery with the CPU standing in for the GPU: a
    captured front-end call agrees with itself, missing programs fail."""
    cfg = orb.OrbConfig(height=96, width=128, n_features=120, n_levels=2)
    cam = render.RenderCam(width=128, height=96, fx=64, fy=64, cx=64, cy=48)
    R, t = render.orbit_pose(0.3, 2.5)[:2]
    img = render.RoomScene(seed=3).render(R, t, cam).astype(np.float32)
    cap = C.Capture()
    box = [jax.jit(lambda im: orb.extract_orb(im, cfg))]
    cap.patch(box, 0, "extract")
    box[0](jnp.asarray(img))
    devs = jax.devices()
    r = C.phase2(cap, devs[1], devs[0])
    entries = {e["program"]: e for e in r["programs"]}
    ex = entries["extract"]
    assert ex["ok"], ex
    assert [run["precision"] for run in ex["runs"]] == ["default",
                                                         "highest"]
    assert ex["runs"][0]["metrics"]["features"]["kp_same_frac"] == 1.0
    assert set(ex["tol"]) == set(ex["why"]) == {"features"}
    assert entries["global_ba"]["error"] == "not captured"
    assert not r["ok"]


def test_comparisons_flag_real_differences():
    q = np.array([[1.0, 0, 0, 0]], np.float32)
    q2 = np.array([[np.cos(0.005), np.sin(0.005), 0, 0]], np.float32)
    t = np.zeros((1, 3), np.float32)
    m = C.cmp_poses(q, t, q2, t + 0.001)["poses"]
    assert m["angle_rad"] == pytest.approx(0.01, rel=1e-3)
    assert not C._check(m, C.TOL["poses"][0])
    assert C._check(C.cmp_poses(q, t, q, t)["poses"], C.TOL["poses"][0])
    assert C.cmp_equal(np.arange(4), np.array([0, 1, 2, 0]))["exact"][
        "equal_frac"] == 0.75


def test_four_device_gba_on_virtual_cpus():
    """The --four-gpus comparison on four virtual CPU devices (the
    psum-CG path: more free keyframes than the dense cap)."""
    devs = jax.devices()
    assert len(devs) >= 4
    r = C.four_gpus(devs, n_kf=40, n_pt=1024)
    assert r["free_kfs"] > 32
    assert r["ok"], {k: r[k] for k in ("cost_rel", "pose_delta",
                                       "cost_dist", "cost_single")}
    assert r["shards_spread"] is None  # the CPU reports no memory stats


def test_ok_share_counts_from_first_ok():
    from mam3slam_tpu.slam.system import NOT_INITIALIZED as N, OK, LOST
    assert C.ok_share([N, N, OK, OK, LOST, OK]) == pytest.approx(0.75)
    assert C.ok_share([N, N]) == 0.0

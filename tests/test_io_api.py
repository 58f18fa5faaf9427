"""Settings parsing, artifact writers, and the MultiAgentSystem facade."""

import os

import numpy as np
import pytest

from mam3slam_tpu.io import settings as S
from mam3slam_tpu.io import writers

pytestmark = pytest.mark.slow  # full-suite tier; smoke = -m "not slow"

PINHOLE_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 0.0000176187114
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 700
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_load_settings_pinhole(tmp_path):
    p = tmp_path / "cam.yaml"
    p.write_text(PINHOLE_YAML)
    st = S.load_settings(str(p))
    assert st.camera_type == "PinHole"
    assert st.fx == pytest.approx(458.654)
    assert st.dist[0] == pytest.approx(-0.28340811)
    assert st.width == 752 and st.height == 480
    assert st.n_features == 700 and st.n_levels == 8
    cam = st.camera()
    assert cam.kind == 0


def test_load_settings_reference_fixture(tmp_path):
    """Parse the reference's own KB8 test fixture."""
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(__file__))
    from test_settings_parser import KB8_FIXTURE

    p = tmp_path / "settingsForTest_00.yaml"
    p.write_text(KB8_FIXTURE)
    st = S.load_settings(str(p))
    assert st.camera_type == "KannalaBrandt8"
    assert st.width == 960 and st.height == 960
    assert st.n_features == 700
    cam = st.camera()
    assert cam.kind == 1


def test_settings_version_gate(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text(PINHOLE_YAML.replace('File.version: "1.0"', ""))
    with pytest.raises(S.SettingsError):
        S.load_settings(str(p))


def test_writers_full_artifact_set(tmp_path):
    # build a tiny run via the synthetic e2e harness
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(__file__))
    from test_slam_e2e import run_slam

    sys_, aid, poses, states = run_slam(n_frames=30, seed=7)
    out = str(tmp_path / "output")
    writers.save_all(sys_, sys_.server, out)
    for fname in ["Trajectory_0.txt", "KF_traj.txt", "MapLogs.txt",
                  "TrackingStatus_0.txt", "TimesT_0.txt", "reloc.txt"]:
        assert os.path.exists(os.path.join(out, fname)), fname

    # schema: trajectory rows parse as reference format
    with open(os.path.join(out, "Trajectory_0.txt")) as f:
        header = f.readline().split()
        assert header == ["ts", "tx", "ty", "tz", "qx", "qy", "qz", "qw",
                          "agent", "ref_KF_ts"]
        row = f.readline().split()
        assert len(row) == 10
        floats = [float(v) for v in row]
        # unit quaternion
        q = np.array(floats[4:8])
        assert abs(np.linalg.norm(q) - 1) < 1e-4

    with open(os.path.join(out, "KF_traj.txt")) as f:
        header = f.readline().split()
        assert header[-2:] == ["agent", "map"]
        assert len(f.readline().split()) == 10


def test_writers_legacy_formats(tmp_path):
    """TUM / KITTI facade exporters (reference System.cc:593-1276):
    row shapes, timestamp ordering, orthonormal KITTI rotations, and
    first-KF-at-origin normalization."""
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(__file__))
    from test_slam_e2e import run_slam

    sys_, aid, poses, states = run_slam(n_frames=30, seed=7)

    tum = str(tmp_path / "traj_tum.txt")
    writers.save_trajectory_tum(sys_, aid, tum)
    rows = [l.split() for l in open(tum)]
    assert rows and all(len(r) == 8 for r in rows)
    q = np.array([[float(v) for v in r[4:8]] for r in rows])
    assert np.allclose(np.linalg.norm(q, axis=1), 1, atol=1e-4)

    kf_tum = str(tmp_path / "kf_tum.txt")
    writers.save_kf_trajectory_tum(sys_, kf_tum)
    krows = [l.split() for l in open(kf_tum)]
    assert krows and all(len(r) == 8 for r in krows)
    ts = np.array([float(r[0]) for r in krows])
    assert np.all(np.diff(ts) >= 0)  # timestamp-sorted like the facade

    kitti = str(tmp_path / "traj_kitti.txt")
    writers.save_trajectory_kitti(sys_, aid, kitti)
    mrows = np.array([[float(v) for v in l.split()] for l in open(kitti)])
    assert mrows.shape[1] == 12 and len(mrows) == len(rows)
    P = mrows.reshape(-1, 3, 4)
    R, t = P[:, :, :3], P[:, :, 3]
    assert np.allclose(R @ np.swapaxes(R, 1, 2),
                       np.eye(3)[None], atol=1e-4)  # orthonormal
    # the frame taken at the first keyframe's pose sits at the origin
    assert np.min(np.linalg.norm(t, axis=1)) < 0.05


def test_viewer_renders(tmp_path):
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(__file__))
    from test_slam_e2e import run_slam
    from mam3slam_tpu.io import viewer

    sys_, aid, poses, states = run_slam(n_frames=25, seed=8)
    path = str(tmp_path / "map.png")
    viewer.render_map(sys_, path)
    assert os.path.getsize(path) > 10000

"""The OpenCV-FileStorage settings parser (io/settings.py) on embedded
fixture files, without PyYAML."""

import os
import subprocess
import sys

import pytest

from mam3slam_tpu.io import settings as S

# the reference's own KB8 fixture (test/settingsForTest_00.yaml), as the
# reference ships it: header, comments, quoted strings, a matrix block
KB8_FIXTURE = """%YAML:1.0

#--------------------------------------------------------------------------------------------
# System config
#--------------------------------------------------------------------------------------------

File.version: "1.0"

#--------------------------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------------------------
Camera.type: "KannalaBrandt8"

# Camera calibration and distortion parameters (OpenCV)
Camera1.fx: 470.2
Camera1.fy: 470.2
Camera1.cx: 479.9
Camera1.cy: 479.9

Camera1.k1: 0.0034823894022493434
Camera1.k2: 0.0007150348452162257
Camera1.k3: -0.0020532361418706202
Camera1.k4: 0.00020293673591811182

# Camera resolution
Camera.width: 960
Camera.height: 960

# Camera frames per second
Camera.fps: 20

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Transformation from body-frame (imu) to camera
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]

#--------------------------------------------------------------------------------------------
# ORB Parameters
#--------------------------------------------------------------------------------------------
ORBextractor.nFeatures: 700 # number of features per image
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.05
Viewer.ViewpointF: 500.0
System.SaveAtlasToFile: 'atlas #1'
"""

EUROC_PINHOLE = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.newWidth: 600
Camera.newHeight: 350
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _load(tmp_path, text):
    p = tmp_path / "cam.yaml"
    p.write_text(text)
    return S.load_settings(str(p))


def test_kb8_fixture(tmp_path):
    st = _load(tmp_path, KB8_FIXTURE)
    assert st.camera_type == "KannalaBrandt8"
    assert (st.width, st.height, st.fps) == (960, 960, 20.0)
    assert st.fx == 470.2 and st.cy == 479.9
    assert st.dist == pytest.approx((0.0034823894022493434,
                                     0.0007150348452162257,
                                     -0.0020532361418706202,
                                     0.00020293673591811182))
    assert (st.n_features, st.n_levels, st.scale_factor) == (700, 8, 1.2)
    assert (st.ini_th_fast, st.min_th_fast) == (20, 7)
    assert st.atlas_save_file == "atlas #1"  # '#' inside quotes stays
    assert st.camera().kind == 1


def test_pinhole_fixture_with_resize(tmp_path):
    st = _load(tmp_path, EUROC_PINHOLE)
    assert st.camera_type == "PinHole"
    assert st.dist[3] == pytest.approx(1.76187114e-05)
    assert (st.eff_width, st.eff_height) == (600, 350)
    cam = st.camera()
    assert cam.kind == 0
    assert float(cam.params[0]) == pytest.approx(458.654 * 600 / 752)


def test_values_and_blocks():
    d = S.parse_filestorage(KB8_FIXTURE)
    assert isinstance(d["Camera.width"], int)
    assert isinstance(d["Camera1.fx"], float)
    assert d["File.version"] == "1.0"
    m = d["IMU.T_b_c1"]
    assert (m["rows"], m["cols"], m["dt"]) == (4, 4, "f")
    assert m["data"] == [1.0 if i % 5 == 0 else 0.0 for i in range(16)]
    assert d["ORBextractor.nFeatures"] == 700  # trailing comment dropped


@pytest.mark.parametrize("text", [
    KB8_FIXTURE.replace('File.version: "1.0"', ""),
    KB8_FIXTURE.replace('File.version: "1.0"', 'File.version: "2.0"'),
])
def test_version_gate(tmp_path, text):
    with pytest.raises(S.SettingsError):
        _load(tmp_path, text)


@pytest.mark.parametrize("text", [
    "%YAML:1.0\nno colon here\n",
    "%YAML:1.0\n   indented: 1\n",
    "%YAML:1.0\nM: !!opencv-matrix\n   data: [1, 2,\n",
])
def test_malformed_raises(text):
    with pytest.raises(S.SettingsError):
        S.parse_filestorage(text)


def test_api_imports_without_optional_packages():
    """``from mam3slam_tpu import api`` needs neither PyYAML, OpenCV nor
    matplotlib."""
    code = ("import sys\n"
            "for m in ('yaml', 'cv2', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "from mam3slam_tpu import api\n"
            "from mam3slam_tpu.io import settings\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")

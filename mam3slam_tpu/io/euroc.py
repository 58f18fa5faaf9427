"""EuRoC MAV dataset driver (ASL format).

Replaces the reference's (missing-from-tree) ``test/mono_euroc.cc`` driver
and the ROS image-topic feeders (``Examples/ROS/MAM3SLAM`` — SURVEY.md
§2.7): iterates ``mav0/cam0/data.csv`` timestamps + PNGs and ground truth
from ``state_groundtruth_estimate0`` for ATE evaluation.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def load_image_index(seq_dir: str, cam: str = "cam0") -> List[Tuple[float, str]]:
    """[(timestamp_s, image_path)] from mav0/<cam>/data.csv."""
    cam_dir = os.path.join(seq_dir, "mav0", cam)
    csv_path = os.path.join(cam_dir, "data.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(
            f"not an EuRoC ASL sequence dir (no {csv_path}); expected "
            f"layout <seq>/mav0/{cam}/data.csv")
    out = []
    with open(csv_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts_ns, fname = row[0], row[1].strip()
            out.append((int(ts_ns) * 1e-9,
                        os.path.join(cam_dir, "data", fname)))
    out.sort()
    return out


def load_groundtruth(seq_dir: str) -> np.ndarray:
    """[(t, x, y, z)] from the ground-truth CSV (for ATE)."""
    path = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0",
                        "data.csv")
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append([int(row[0]) * 1e-9] + [float(v) for v in row[1:4]])
    return np.array(rows)


_LOADER_LIB = None


def _load_native():
    """ctypes handle to native/libloader.so (PNG decode + prefetch ring)."""
    global _LOADER_LIB
    if _LOADER_LIB is not None:
        return _LOADER_LIB or None
    import ctypes

    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libloader.so")
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
        lib.loader_open.restype = ctypes.c_void_p
        lib.loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int64, ctypes.c_int64]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.loader_close.argtypes = [ctypes.c_void_p]
        lib.decode_png_gray.restype = ctypes.c_int
        lib.decode_png_gray.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        _LOADER_LIB = lib
    except OSError:
        _LOADER_LIB = False
        return None
    return _LOADER_LIB


def frames(seq_dir: str, cam: str = "cam0",
           max_frames: Optional[int] = None, backend: str = "auto",
           max_hw: Tuple[int, int] = (1536, 2048)
           ) -> Iterator[Tuple[float, np.ndarray]]:
    """Yield (timestamp_s, grayscale f32 [H, W]) frames.

    ``backend`` "auto" prefers the native C++ loader (zlib PNG decode on a
    prefetch thread, native/loader.cc — this build's analog of the
    reference's C++ ROS image feeders), falling back to cv2.
    """
    import ctypes

    index = load_image_index(seq_dir, cam)
    if max_frames:
        index = index[:max_frames]

    lib = _load_native() if backend in ("auto", "native") else None
    if lib is not None:
        paths = (ctypes.c_char_p * len(index))(
            *[p.encode() for _, p in index])
        handle = lib.loader_open(paths, len(index), 8)
        buf = np.empty(max_hw, np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        try:
            for ts, _ in index:
                rc = lib.loader_next(handle, buf.ctypes.data, buf.nbytes,
                                     ctypes.byref(w), ctypes.byref(h))
                if rc < 0:
                    break
                if rc == 0:
                    continue
                img = buf.flat[: w.value * h.value].reshape(
                    h.value, w.value).astype(np.float32)
                yield ts, img
        finally:
            lib.loader_close(handle)
        return
    if backend == "native":
        raise RuntimeError("native loader unavailable (run native/build.sh)")

    import cv2

    for ts, path in index:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        yield ts, img.astype(np.float32)


EUROC_CAM0 = dict(  # factory calibration of EuRoC cam0 (public)
    fx=458.654, fy=457.296, cx=367.215, cy=248.375,
    dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    width=752, height=480, fps=20.0,
)


def load_sensor_yaml(seq_dir: str, cam: str = "cam0") -> Optional[dict]:
    """Per-sequence calibration from ``mav0/<cam>/sensor.yaml`` (ASL
    format, present in real EuRoC sequences and in rendered datasets from
    io/render.py).  Returns the EUROC_CAM0-shaped dict, or None."""
    path = os.path.join(seq_dir, "mav0", cam, "sensor.yaml")
    if not os.path.exists(path):
        return None

    def _floats(line: str) -> List[float]:
        body = line.split("[", 1)[1].split("]", 1)[0]
        return [float(v) for v in body.split(",") if v.strip()]

    vals = {}
    with open(path) as f:
        for line in f:
            key = line.split(":", 1)[0].strip()
            if key in ("intrinsics", "resolution",
                       "distortion_coefficients"):
                vals[key] = _floats(line)
            elif key == "rate_hz":
                vals[key] = float(line.split(":", 1)[1])
            elif key in ("camera_model", "distortion_model"):
                vals[key] = line.split(":", 1)[1].strip()
    if "intrinsics" not in vals or "resolution" not in vals:
        return None
    fu, fv, cu, cv = vals["intrinsics"][:4]
    w, h = vals["resolution"][:2]
    dist = tuple(vals.get("distortion_coefficients",
                          [0.0, 0.0, 0.0, 0.0])[:4])
    model = ("kb8" if vals.get("camera_model") == "kb8"
             or vals.get("distortion_model") == "equidistant"
             else "pinhole")
    return dict(fx=fu, fy=fv, cx=cu, cy=cv, dist=dist,
                width=int(w), height=int(h),
                fps=float(vals.get("rate_hz", 20.0)), model=model)

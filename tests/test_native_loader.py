"""Native PNG loader: byte-exact vs cv2, prefetch stream over an
EuRoC-layout directory."""

import os

import cv2
import numpy as np
import pytest

from mam3slam_tpu.io import euroc

# full-suite tier; smoke = -m "not slow"
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("native_libs")]

RNG = np.random.default_rng(51)


def _write_euroc_seq(root, n=6, h=120, w=160):
    cam_dir = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam_dir, "data"))
    rows = ["#timestamp [ns],filename\n"]
    imgs = []
    for i in range(n):
        img = RNG.integers(0, 256, (h, w), dtype=np.uint8)
        # structured content so PNG filters actually vary
        img[i * 10:i * 10 + 20, :] = np.arange(w, dtype=np.uint8)[None, :]
        name = f"{1000000000 + i}.png"
        cv2.imwrite(os.path.join(cam_dir, "data", name), img)
        rows.append(f"{1000000000 + i},{name}\n")
        imgs.append(img)
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.writelines(rows)
    return imgs


def test_native_decode_byte_exact(tmp_path):
    lib = euroc._load_native()
    assert lib is not None, "run native/build.sh"
    import ctypes

    img = RNG.integers(0, 256, (240, 320), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, img)
    buf = np.empty((1024, 1024), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.decode_png_gray(p.encode(), buf.ctypes.data, buf.nbytes,
                             ctypes.byref(w), ctypes.byref(h))
    assert rc == 1 and (h.value, w.value) == (240, 320)
    got = buf.flat[:240 * 320].reshape(240, 320)
    np.testing.assert_array_equal(got, img)


def test_native_decode_rgb_to_luma(tmp_path):
    lib = euroc._load_native()
    import ctypes

    rgb = RNG.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, rgb)  # cv2 writes BGR
    buf = np.empty((256, 256), np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.decode_png_gray(p.encode(), buf.ctypes.data, buf.nbytes,
                             ctypes.byref(w), ctypes.byref(h))
    assert rc == 1
    got = buf.flat[:60 * 80].reshape(60, 80).astype(np.int32)
    # PNG stores RGB; cv2 wrote BGR -> file R=rgb[...,2] etc.
    r64 = rgb.astype(np.int64)
    want = (299 * r64[..., 2] + 587 * r64[..., 1] + 114 * r64[..., 0]) // 1000
    assert np.abs(got - want).max() <= 1


def test_prefetch_stream_matches_cv2(tmp_path):
    imgs = _write_euroc_seq(str(tmp_path))
    native = list(euroc.frames(str(tmp_path), backend="native"))
    cv2_out = list(euroc.frames(str(tmp_path), backend="cv2"))
    assert len(native) == len(imgs) == len(cv2_out)
    for (ts_n, im_n), (ts_c, im_c), ref in zip(native, cv2_out, imgs):
        assert ts_n == ts_c
        np.testing.assert_array_equal(im_n.astype(np.uint8), ref)
        np.testing.assert_array_equal(im_c.astype(np.uint8), ref)


def test_loader_handles_missing_file(tmp_path):
    _write_euroc_seq(str(tmp_path), n=3)
    # corrupt one file
    cam = os.path.join(str(tmp_path), "mav0", "cam0", "data")
    victim = sorted(os.listdir(cam))[1]
    with open(os.path.join(cam, victim), "wb") as f:
        f.write(b"not a png")
    out = list(euroc.frames(str(tmp_path), backend="native"))
    assert len(out) == 2  # bad frame skipped, stream continues

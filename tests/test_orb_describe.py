"""The describe stage that runs on every platform -- IC angle and rBRIEF
as element gathers from the stacked pyramid -- bit-checked against
OpenCV's ORB on its own level-0 keypoints."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from mam3slam_tpu.ops import orb


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 120.0, np.float32)
    for _ in range(400):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        bh, bw = rng.integers(4, 16), rng.integers(4, 16)
        img[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    img += rng.normal(0, 2.0, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_level0(img):
    o = cv2.ORB_create(nfeatures=500, nlevels=1, edgeThreshold=19,
                       patchSize=31, fastThreshold=20)
    kps, desc = o.detectAndCompute(img, None)
    keep = [(kp, d) for kp, d in zip(kps, desc) if kp.octave == 0]
    xy = np.array([[round(kp.pt[0]), round(kp.pt[1])] for kp, _ in keep],
                  np.int32)
    ang = np.array([kp.angle for kp, _ in keep], np.float32)
    return xy, ang, np.array([d for _, d in keep])


@pytest.mark.parametrize("seed", [9, 21])
def test_brief_bits_match_opencv(seed):
    """At OpenCV's own angles, the gathered rBRIEF is bit-exact."""
    h, w = 480, 640
    img = _image(h, w, seed)
    xy, ang, cv_desc = _cv2_level0(img)
    assert len(xy) > 50
    blur = jnp.round(orb.gaussian_blur(jnp.asarray(img, jnp.float32)))[None]
    hw = jnp.asarray(np.tile([[h, w]], (len(xy), 1)), jnp.int32)
    ours = np.asarray(orb._brief_descriptors_gather(
        blur, jnp.asarray(xy), jnp.zeros(len(xy), jnp.int32), hw,
        jnp.asarray(np.deg2rad(ang))))
    dists = np.unpackbits(ours ^ cv_desc, axis=1).sum(1)
    assert np.median(dists) == 0, np.median(dists)
    assert dists.mean() < 1.0, dists.mean()


@pytest.mark.parametrize("seed", [5, 13])
def test_ic_angle_then_brief_close_to_opencv(seed):
    """The whole describe stage -- our IC angle, then rBRIEF at it --
    against OpenCV's descriptors."""
    h, w = 480, 640
    img = _image(h, w, seed)
    xy, ang_cv, cv_desc = _cv2_level0(img)
    f32 = jnp.asarray(img, jnp.float32)[None]
    lvl = jnp.zeros(len(xy), jnp.int32)
    ang = orb._ic_angles_gather(f32, jnp.asarray(xy), lvl)
    d_ang = np.abs(((np.rad2deg(np.asarray(ang)) - ang_cv) + 180) % 360
                   - 180)
    assert np.median(d_ang) < 0.5, np.median(d_ang)
    hw = jnp.asarray(np.tile([[h, w]], (len(xy), 1)), jnp.int32)
    ours = np.asarray(orb._brief_descriptors_gather(
        jnp.round(orb.gaussian_blur(f32[0]))[None], jnp.asarray(xy), lvl,
        hw, ang))
    dists = np.unpackbits(ours ^ cv_desc, axis=1).sum(1)
    assert np.median(dists) <= 1, np.median(dists)
    assert dists.mean() < 4.0, dists.mean()


def test_extract_uses_the_gather_forms():
    """extract_orb's descriptors are exactly the gather forms applied to
    its own stacked pyramid and keypoints."""
    img = _image(240, 320, 3).astype(np.float32)
    cfg = orb.OrbConfig(height=240, width=320, n_features=300, n_levels=3)
    feats = orb.extract_orb(jnp.asarray(img), cfg)
    _, lvl_np, scales_np, hws_np = orb._stack_constants(cfg)
    n = len(lvl_np)
    xy_i = np.round(np.asarray(feats.xy)[:n] / scales_np[:, None]).astype(
        np.int32)
    Hp, Wp = cfg.level_sizes[0]
    pyr = orb.compute_pyramid(jnp.asarray(img), cfg)
    stack = []
    for lv, x in enumerate(pyr):
        h, w = cfg.level_sizes[lv]
        ry, rx = min(3, Hp - h), min(3, Wp - w)
        x = jnp.pad(x, ((0, ry), (0, rx)), mode="reflect")
        stack.append(jnp.pad(x, ((0, Hp - h - ry), (0, Wp - w - rx))))
    stack = jnp.stack(stack)
    lvl = jnp.asarray(lvl_np)
    ang = orb._ic_angles_gather(stack, jnp.asarray(xy_i), lvl)
    desc = orb._brief_descriptors_gather(
        jnp.round(orb.gaussian_blur(stack)), jnp.asarray(xy_i), lvl,
        jnp.asarray(hws_np), ang)
    v = np.asarray(feats.valid)[:n]
    assert v.sum() > 100
    np.testing.assert_array_equal(np.asarray(desc)[v],
                                  np.asarray(feats.desc)[:n][v])

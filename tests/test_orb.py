"""ORB extraction tests vs OpenCV oracles (FAST, ORB descriptors)."""

import cv2
import numpy as np
import jax.numpy as jnp

from mam3slam_tpu.ops import orb

import pytest

pytestmark = pytest.mark.slow  # full-suite tier; smoke = -m "not slow"

RNG = np.random.default_rng(7)


def synth_image(h=240, w=320, n_blobs=120, seed=3):
    """Textured synthetic image with corner-rich structure."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 120.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        bh, bw = rng.integers(4, 16), rng.integers(4, 16)
        img[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    img += rng.normal(0, 2.0, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.float32)


def test_fast_score_agrees_with_cv2_detection():
    img = synth_image()
    score = np.asarray(orb.fast_score_map(jnp.asarray(img)))

    det = cv2.FastFeatureDetector_create(threshold=20,
                                         nonmaxSuppression=False)
    kps = det.detect(img.astype(np.uint8))
    cv_mask = np.zeros(img.shape, bool)
    for kp in kps:
        cv_mask[int(kp.pt[1]), int(kp.pt[0])] = True

    ours = score > 20
    inner = np.zeros_like(cv_mask)
    inner[5:-5, 5:-5] = True
    cv_in = cv_mask & inner
    ours_in = ours & inner
    # uint8 rounding vs f32 input gives tiny borderline flips; demand
    # near-complete mutual agreement.
    recall = (cv_in & ours_in).sum() / max(cv_in.sum(), 1)
    precision = (cv_in & ours_in).sum() / max(ours_in.sum(), 1)
    assert recall > 0.95, recall
    assert precision > 0.95, precision


def test_fast_score_value_matches_cv2_threshold_sweep():
    # score > t must exactly track cv2 detection at threshold t (mod rounding)
    img = synth_image(seed=11)
    score = np.asarray(orb.fast_score_map(jnp.asarray(img)))
    for t in (10, 30):
        det = cv2.FastFeatureDetector_create(threshold=t,
                                             nonmaxSuppression=False)
        kps = det.detect(img.astype(np.uint8))
        cv_mask = np.zeros(img.shape, bool)
        for kp in kps:
            cv_mask[int(kp.pt[1]), int(kp.pt[0])] = True
        ours = score > t
        inner = np.zeros(img.shape, bool)
        inner[5:-5, 5:-5] = True
        agree = (cv_mask & ours & inner).sum()
        assert agree / max((cv_mask & inner).sum(), 1) > 0.93


def test_extract_counts_and_validity():
    img = synth_image(480, 640, n_blobs=400)
    cfg = orb.OrbConfig(height=480, width=640, n_features=500)
    feats = orb.extract_orb(jnp.asarray(img), cfg)
    n_valid = int(np.asarray(feats.valid).sum())
    assert n_valid > 350  # textured image should nearly fill the budget
    v = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[v]
    assert xy[:, 0].min() >= 0 and xy[:, 0].max() < 640
    assert xy[:, 1].min() >= 0 and xy[:, 1].max() < 480
    # spatial spread: at least 25% of 40px cells occupied
    cells = set(map(tuple, (xy // 40).astype(int)))
    assert len(cells) > 0.25 * (640 // 40) * (480 // 40)


def _cv2_level0_kps(img, n=500):
    """cv2 ORB's own detected level-0 keypoints (they carry IC angles)."""
    o = cv2.ORB_create(nfeatures=n, nlevels=1, edgeThreshold=19, patchSize=31,
                       fastThreshold=20)
    kps, desc = o.detectAndCompute(img.astype(np.uint8), None)
    keep = [(kp, d) for kp, d in zip(kps, desc) if kp.octave == 0]
    return keep


def _level0(xy):
    """Stacked-pyramid arguments for keypoints on one level-0 image."""
    n = len(xy)
    return jnp.asarray(xy, jnp.int32), jnp.zeros(n, jnp.int32)


def test_orientation_matches_cv2_orb():
    img = synth_image(480, 640, n_blobs=400, seed=5)
    pairs = _cv2_level0_kps(img)
    assert len(pairs) > 50
    xy = np.array([[round(kp.pt[0]), round(kp.pt[1])] for kp, _ in pairs],
                  np.int32)
    ang = np.asarray(orb._ic_angles_gather(jnp.asarray(img)[None],
                                           *_level0(xy)))
    ours = np.rad2deg(ang) % 360.0
    cv = np.array([kp.angle for kp, _ in pairs])
    diffs = np.abs(((ours - cv) + 180) % 360 - 180)
    assert np.median(diffs) < 3.0, np.median(diffs)


def test_descriptors_close_to_cv2():
    img = synth_image(480, 640, n_blobs=400, seed=9)
    pairs = _cv2_level0_kps(img)
    assert len(pairs) > 50
    xy = np.array([[round(kp.pt[0]), round(kp.pt[1])] for kp, _ in pairs],
                  np.int32)
    ang = np.array([np.deg2rad(kp.angle) for kp, _ in pairs], np.float32)
    cv_desc = np.array([d for _, d in pairs])

    # match cv2's arithmetic: uint8 input, blur rounded to the integer grid
    u8 = img.astype(np.uint8).astype(np.float32)
    blur = jnp.round(orb.gaussian_blur(jnp.asarray(u8)))[None]
    hw = jnp.asarray(np.tile([[480, 640]], (len(xy), 1)), jnp.int32)
    ours = np.asarray(orb._brief_descriptors_gather(
        blur, *_level0(xy), hw, jnp.asarray(ang)))
    dists = np.array([np.unpackbits(a ^ b).sum()
                      for a, b in zip(ours, cv_desc)])
    # bit-exact parity with OpenCV ORB descriptors (mean ~0.002 bits)
    assert np.median(dists) <= 1, np.median(dists)
    assert dists.mean() < 2, dists.mean()


def test_extract_jits_and_is_deterministic():
    import jax

    img = synth_image(240, 320)
    cfg = orb.OrbConfig(height=240, width=320, n_features=200, n_levels=4)
    f = jax.jit(lambda im: orb.extract_orb(im, cfg))
    a = f(jnp.asarray(img))
    b = f(jnp.asarray(img))
    np.testing.assert_array_equal(np.asarray(a.desc), np.asarray(b.desc))
    np.testing.assert_array_equal(np.asarray(a.xy), np.asarray(b.xy))

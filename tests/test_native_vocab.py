"""Native C++ vocabulary trainer: parity with the numpy trainer."""

import time

import numpy as np
import jax.numpy as jnp
import pytest

from mam3slam_tpu.ops import bow

# full-suite tier; smoke = -m "not slow"
pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("native_libs")]


def _clustered_descs(n_clusters=64, per=80, seed=0):
    """Descriptors with real cluster structure (anchor + few bit flips)."""
    rng = np.random.default_rng(seed)
    anchors = rng.integers(0, 256, (n_clusters, 32), dtype=np.uint8)
    out = []
    for a in anchors:
        d = np.tile(a, (per, 1))
        for _ in range(6):
            byte = rng.integers(0, 32, per)
            bit = rng.integers(0, 8, per).astype(np.uint8)
            d[np.arange(per), byte] ^= (1 << bit).astype(np.uint8)
        out.append(d)
    return np.concatenate(out), anchors


def test_native_available_and_functional():
    assert bow._load_native() is not None, "run native/build.sh"
    descs, anchors = _clustered_descs()
    voc = bow.build_vocabulary(descs, k=6, depth=3, backend="native")
    assert voc.n_leaves == 216
    # quantize anchors: noisy copies must land on the same leaf mostly
    bits = jnp.asarray(np.unpackbits(descs, axis=-1, bitorder="little")
                       .astype(np.float32))
    words = np.asarray(bow.quantize(voc, bits))
    # per-cluster purity: most descriptors of a cluster share one word
    purity = []
    for c in range(64):
        w = words[c * 80:(c + 1) * 80]
        purity.append((w == np.bincount(w).argmax()).mean())
    assert np.mean(purity) > 0.8, np.mean(purity)


def test_native_matches_numpy_quality():
    descs, _ = _clustered_descs(seed=3)
    voc_n = bow.build_vocabulary(descs, k=6, depth=2, backend="native")
    voc_p = bow.build_vocabulary(descs, k=6, depth=2, backend="numpy")
    bits = jnp.asarray(np.unpackbits(descs, axis=-1, bitorder="little")
                       .astype(np.float32))

    def mean_purity(voc):
        words = np.asarray(bow.quantize(voc, bits))
        ps = []
        for c in range(64):
            w = words[c * 80:(c + 1) * 80]
            ps.append((w == np.bincount(w).argmax()).mean())
        return np.mean(ps)

    pn, pp = mean_purity(voc_n), mean_purity(voc_p)
    assert pn > pp - 0.1, (pn, pp)  # native at least as good (mod RNG)


def test_native_speed():
    rng = np.random.default_rng(1)
    descs = rng.integers(0, 256, (30000, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    bow.build_vocabulary(descs, k=8, depth=3, backend="native")
    dt = time.perf_counter() - t0
    assert dt < 20.0, dt  # numpy path takes minutes at this size

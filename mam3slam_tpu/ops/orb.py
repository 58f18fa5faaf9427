"""Batched ORB feature extraction (FAST + oriented rBRIEF) in JAX.

Replaces the reference's ``src/ORBextractor.cc`` (SURVEY.md §2.4): 8-level
pyramid at scale 1.2, dual-threshold FAST (20/7) per spatial cell, spatial
redistribution to a per-level budget, intensity-centroid orientation over an
r=15 circular patch, and 256-bit rBRIEF from the standard ``bit_pattern_31``
table (stored as data in ``mam3slam_tpu/data/orb_pattern.npy``).

Design choices (vs the reference's per-cell scalar loops):
* every level is padded to the level-0 extent and stacked, so each stage
  (FAST, NMS, blur, gathers) is one batched op over all levels;
* FAST is evaluated densely as a *score map* (the FAST score is the max
  threshold at which the segment test passes, so one map serves both the
  ini=20 and min=7 thresholds) using 16 shifted image views and rolled
  window-mins — elementwise work, no data-dependent control flow;
* the octree redistribution is replaced by grid-bucket top-K with a
  rank-in-cell penalty: every cell's best corner outranks any cell's
  second-best, reproducing the octree's spatial spreading property
  (SURVEY.md §7 sanctions this substitution; validated by match quality);
* IC orientation and rBRIEF are element gathers from the stacked pyramid
  ([N, 31*31] patch taps, [N, 512] rotated pattern taps); bits pack to the
  same byte/bit order as OpenCV so descriptors are directly comparable.

Every stage has one form on every platform, so the CPU tests check the
numerics the GPU runs (ops/platform.py).

All shapes are static per `OrbConfig`; outputs are fixed-capacity arrays
with validity masks (SURVEY.md §7 "capacity padding + masks").
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                             "orb_pattern.npy")
_PATTERN = np.load(os.path.abspath(_PATTERN_PATH))  # [256, 4] int32 x1 y1 x2 y2

# FAST circle of radius 3 — 16 (dx, dy) offsets in OpenCV order.
_FAST_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    dtype=np.int32,
)  # (dx, dy)

EDGE_THRESHOLD = 19  # reference src/ORBextractor.cc:73
HALF_PATCH = 15      # IC orientation patch radius


class Features(NamedTuple):
    """Fixed-capacity ORB features for one frame; a pytree.

    Replaces the keypoint/descriptor part of the reference ``Frame``
    (``src/Frame.cc`` mono ctor).  ``xy`` is raw level-0 pixel coords,
    ``uv`` the match-space coords (undistorted for pinhole, raw for KB8).
    """

    xy: jnp.ndarray        # [N, 2] f32
    uv: jnp.ndarray        # [N, 2] f32
    level: jnp.ndarray     # [N] i32
    angle: jnp.ndarray     # [N] f32 (radians)
    response: jnp.ndarray  # [N] f32
    desc: jnp.ndarray      # [N, 32] uint8 (256-bit rBRIEF, OpenCV bit order)
    valid: jnp.ndarray     # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


@dataclass(frozen=True)
class OrbConfig:
    """Static extraction config (shapes/budgets resolved in Python)."""

    height: int
    width: int
    n_features: int = 700
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 16          # spatial bucket size for top-K spreading
    per_cell: int = 4       # candidates retained per bucket
    level_sizes: Tuple[Tuple[int, int], ...] = field(default=None)
    level_budgets: Tuple[int, ...] = field(default=None)

    def __post_init__(self):
        sizes = []
        h, w = self.height, self.width
        for lv in range(self.n_levels):
            s = self.scale_factor ** lv
            sizes.append((int(round(self.height / s)), int(round(self.width / s))))
        object.__setattr__(self, "level_sizes", tuple(sizes))
        # Geometric per-level budget, mirroring ORBextractor ctor semantics
        # (reference src/ORBextractor.cc: mnFeaturesPerLevel).
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = []
        acc = 0
        for lv in range(self.n_levels - 1):
            b = int(round(n0 * f ** lv))
            budgets.append(b)
            acc += b
        budgets.append(max(self.n_features - acc, 0))
        object.__setattr__(self, "level_budgets", tuple(budgets))

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** lv for lv in range(self.n_levels))

    @property
    def capacity(self) -> int:
        # padded total feature capacity (multiple of 128 for clean tiling)
        n = sum(self.level_budgets)
        return ((n + 127) // 128) * 128


# ---------------------------------------------------------------------------
# pyramid + blur
# ---------------------------------------------------------------------------

def compute_pyramid(img: jnp.ndarray, cfg: OrbConfig):
    """f32 [H, W] -> tuple of per-level images (each resized from previous,
    as the reference's ComputePyramid does)."""
    levels = [img]
    for lv in range(1, cfg.n_levels):
        prev = levels[-1]
        h, w = cfg.level_sizes[lv]
        levels.append(jax.image.resize(prev, (h, w), method="bilinear"))
    return tuple(levels)


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect-101 border (matches the
    reference's cv::GaussianBlur(7,7,2,2,BORDER_REFLECT_101)).

    Implemented as explicit shifted adds (7+7 taps), which XLA fuses into
    one elementwise kernel.  Supports [..., H, W].
    """
    k = _gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    nb = img.ndim - 2
    pad_v = [(0, 0)] * nb + [(r, r), (0, 0)]
    x = jnp.pad(img, pad_v, mode="reflect")
    out = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(x, i, i + h, axis=nb)
        out = term if out is None else out + term
    pad_h = [(0, 0)] * nb + [(0, 0), (r, r)]
    x = jnp.pad(out, pad_h, mode="reflect")
    out = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(x, i, i + w, axis=nb + 1)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# FAST score map
# ---------------------------------------------------------------------------

def fast_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9/16 corner score (max passing threshold), [..., H, W] f32.

    score(p) = max over bright/dark polarity and over the 16 circular arc
    start positions of the minimum contiguous-9 difference.  A pixel is an
    OpenCV FAST corner at threshold t iff score > t, so one map serves the
    reference's dual-threshold scheme (iniThFAST=20 / minThFAST=7).
    Batch dims (e.g. a stacked pyramid) evaluate in one fused kernel.
    """
    nb = img.ndim - 2
    h, w = img.shape[-2], img.shape[-1]
    pad = jnp.pad(img, [(0, 0)] * nb + [(3, 3), (3, 3)], mode="edge")
    # Keep the 16 shifted views as separate slice expressions (NOT stacked/
    # concatenated): a stack forces XLA to materialize [16, ..., H, W]
    # intermediates in HBM; as a flat elementwise DAG over slices of one
    # padded buffer the whole score fuses into a single kernel.
    diffs = [
        jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(pad, 3 + dy, 3 + dy + h, axis=nb),
            3 + dx, 3 + dx + w, axis=nb + 1) - img
        for dx, dy in _FAST_OFFSETS]

    def arc_min_max(d):
        """max over the 16 arc starts of the min over 9 contiguous diffs,
        via sliding-window re-association: min9[i] = min(min3[i],
        min3[i+3], min3[i+6]) — 4 min-ops per start instead of 8."""
        m3 = [jnp.minimum(jnp.minimum(d[i], d[(i + 1) % 16]),
                          d[(i + 2) % 16]) for i in range(16)]
        m9 = [jnp.minimum(jnp.minimum(m3[i], m3[(i + 3) % 16]),
                          m3[(i + 6) % 16]) for i in range(16)]
        out = m9[0]
        for i in range(1, 16):
            out = jnp.maximum(out, m9[i])
        return out

    score_bright = arc_min_max(diffs)            # center darker than arc
    score_dark = arc_min_max([-d for d in diffs])  # center brighter
    return jnp.maximum(score_bright, score_dark)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression mask (strictly greater than 8-neighborhood,
    ties broken toward the raster-first pixel via epsilon on index).
    Supports [..., H, W]."""
    nb = score.ndim - 2
    h, w = score.shape[-2], score.shape[-1]
    p = jnp.pad(score, [(0, 0)] * nb + [(1, 1), (1, 1)],
                mode="constant", constant_values=-jnp.inf)
    m = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(p, 1 + dy, 1 + dy + h, axis=nb),
                1 + dx, 1 + dx + w, axis=nb + 1)
            m = n if m is None else jnp.maximum(m, n)
    return score >= m


# ---------------------------------------------------------------------------
# per-level keypoint selection (grid-bucket top-K)
# ---------------------------------------------------------------------------

def _select_level_keypoints(score: jnp.ndarray, cfg: OrbConfig, budget: int):
    """Pick `budget` spatially-spread corners from a level score map.

    Returns (xy_i32 [budget, 2] (x, y), response [budget], valid [budget]).
    """
    h, w = score.shape
    border = EDGE_THRESHOLD - 3  # match reference detection border (=16)
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    in_border = ((ys[:, None] >= border) & (ys[:, None] < h - border)
                 & (xs[None, :] >= border) & (xs[None, :] < w - border))
    nms = _nms3(score)
    eligible = in_border & nms & (score > cfg.min_th)
    s = jnp.where(eligible, score, -jnp.inf)

    cell = cfg.cell
    hc, wc = -(-h // cell), -(-w // cell)
    s_pad = jnp.pad(s, ((0, hc * cell - h), (0, wc * cell - w)),
                    constant_values=-jnp.inf)
    buckets = s_pad.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3)
    buckets = buckets.reshape(hc * wc, cell * cell)
    k = min(cfg.per_cell, cell * cell)
    top_v, top_i = jax.lax.top_k(buckets, k)  # [ncells, k]

    # global pixel coords of candidates
    cy = jnp.arange(hc * wc) // wc
    cx = jnp.arange(hc * wc) % wc
    iy = top_i // cell
    ix = top_i % cell
    gy = cy[:, None] * cell + iy
    gx = cx[:, None] * cell + ix

    # Priority: rank-in-cell dominates (octree-style spreading), then the
    # strong-threshold class (iniThFAST), then raw score.
    rank = jnp.broadcast_to(jnp.arange(k)[None, :], top_v.shape)
    strong = (top_v > cfg.ini_th).astype(jnp.float32)
    prio = jnp.where(jnp.isfinite(top_v),
                     -rank.astype(jnp.float32) * 1e6 + strong * 1e3 + top_v,
                     -jnp.inf)

    flat_prio = prio.reshape(-1)
    nsel = min(budget, flat_prio.shape[0])
    sel_p, sel_idx = jax.lax.top_k(flat_prio, nsel)
    sel_x = gx.reshape(-1)[sel_idx]
    sel_y = gy.reshape(-1)[sel_idx]
    sel_v = top_v.reshape(-1)[sel_idx]
    valid = jnp.isfinite(sel_p)
    if nsel < budget:  # tiny levels: pad up
        padn = budget - nsel
        sel_x = jnp.pad(sel_x, (0, padn))
        sel_y = jnp.pad(sel_y, (0, padn))
        sel_v = jnp.pad(sel_v, (0, padn))
        valid = jnp.pad(valid, (0, padn))
    xy = jnp.stack([sel_x, sel_y], axis=-1).astype(jnp.int32)
    return xy, jnp.where(valid, sel_v, 0.0), valid


# ---------------------------------------------------------------------------
# stacked-pyramid batched paths (the production extract_orb internals)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stack_constants(cfg: OrbConfig):
    """Static per-config arrays for the stacked-pyramid path: the per-level
    eligibility mask (detection border inside each level's true extent) and
    per-keypoint-slot level ids / scales / level extents."""
    L = cfg.n_levels
    Hp, Wp = cfg.level_sizes[0]
    border = EDGE_THRESHOLD - 3
    elig = np.zeros((L, Hp, Wp), bool)
    for lv in range(L):
        h, w = cfg.level_sizes[lv]
        elig[lv, border:h - border, border:w - border] = True
    lvl = np.concatenate([np.full(cfg.level_budgets[lv], lv, np.int32)
                          for lv in range(L)])
    scales = np.asarray(cfg.scales, np.float32)[lvl]
    hws = np.array(cfg.level_sizes, np.int32)[lvl]  # [N, 2] (h, w)
    return elig, lvl, scales, hws


def _select_keypoints_stacked(score: jnp.ndarray, cfg: OrbConfig):
    """Batched per-level grid-bucket top-K over a stacked score map.

    score: [L, Hp, Wp] (levels zero-padded to the level-0 extent).
    Returns (xy [N, 2] i32 level coords, response [N], valid [N]) with N =
    sum of level budgets, ordered by level — one top_k call for all levels
    instead of two per level.
    """
    L, Hp, Wp = score.shape
    elig_np, _, _, _ = _stack_constants(cfg)
    nms = _nms3(score)
    eligible = jnp.asarray(elig_np) & nms & (score > cfg.min_th)
    s = jnp.where(eligible, score, -jnp.inf)

    cell = cfg.cell
    hc, wc = -(-Hp // cell), -(-Wp // cell)
    s_pad = jnp.pad(s, ((0, 0), (0, hc * cell - Hp), (0, wc * cell - Wp)),
                    constant_values=-jnp.inf)
    buckets = s_pad.reshape(L, hc, cell, wc, cell).transpose(0, 1, 3, 2, 4)
    buckets = buckets.reshape(L, hc * wc, cell * cell)
    k = min(cfg.per_cell, cell * cell)
    # per-cell top-k via k iterative (max, argmax, mask) rounds: for tiny k
    # these are plain reductions, cheaper than lax.top_k's sort-based
    # lowering over the [L, ncells, cell*cell] volume.  They run in
    # float32 on every platform (bf16 was no faster on the GPU and would
    # re-rank near-equal corners).
    vs, is_ = [], []
    b = buckets
    lane = jnp.arange(cell * cell, dtype=jnp.int32)[None, None, :]
    for r in range(k):
        i = jnp.argmax(b, axis=-1).astype(jnp.int32)
        vs.append(jnp.max(b, axis=-1).astype(jnp.float32))
        is_.append(i)
        if r + 1 < k:
            b = jnp.where(lane == i[..., None], -jnp.inf, b)
    top_v = jnp.stack(vs, axis=-1)   # [L, ncells, k]
    top_i = jnp.stack(is_, axis=-1)

    cy = (jnp.arange(hc * wc) // wc).astype(jnp.int32)
    cx = (jnp.arange(hc * wc) % wc).astype(jnp.int32)
    gy = cy[None, :, None] * cell + (top_i // cell)
    gx = cx[None, :, None] * cell + (top_i % cell)

    rank = jnp.broadcast_to(jnp.arange(k, dtype=jnp.float32)[None, None, :],
                            top_v.shape)
    strong = (top_v > cfg.ini_th).astype(jnp.float32)
    prio = jnp.where(jnp.isfinite(top_v),
                     -rank * 1e6 + strong * 1e3 + top_v, -jnp.inf)

    max_b = max(cfg.level_budgets)
    flat_prio = prio.reshape(L, -1)
    sel_p, sel_idx = jax.lax.top_k(flat_prio, min(max_b, flat_prio.shape[1]))
    sel_x = jnp.take_along_axis(gx.reshape(L, -1), sel_idx, axis=1)
    sel_y = jnp.take_along_axis(gy.reshape(L, -1), sel_idx, axis=1)
    sel_v = jnp.take_along_axis(top_v.reshape(L, -1), sel_idx, axis=1)
    val = jnp.isfinite(sel_p)

    xs, ys, vs, oks = [], [], [], []
    for lv in range(L):
        b = cfg.level_budgets[lv]
        if b == 0:
            continue
        n = min(b, sel_idx.shape[1])
        pad = b - n
        xs.append(jnp.pad(sel_x[lv, :n], (0, pad)))
        ys.append(jnp.pad(sel_y[lv, :n], (0, pad)))
        vs.append(jnp.pad(sel_v[lv, :n], (0, pad)))
        oks.append(jnp.pad(val[lv, :n], (0, pad)))
    xy = jnp.stack([jnp.concatenate(xs), jnp.concatenate(ys)],
                   axis=-1).astype(jnp.int32)
    valid = jnp.concatenate(oks)
    resp = jnp.where(valid, jnp.concatenate(vs), 0.0)
    return xy, resp, valid


def _ic_angles_gather(stack: jnp.ndarray, xy: jnp.ndarray,
                      lvl: jnp.ndarray) -> jnp.ndarray:
    """IC orientation (reference IC_Angle, ORBextractor.cc:76) from one
    [N, 31*31] element gather of each keypoint's patch out of the stacked
    pyramid, weighted by the circular-mask moment tables.  Keypoints sit
    >= 16 px inside their level extent (> r=15), so no window crosses a
    level border; the sums are exact (integer-valued level 0, and every
    partial sum stays far below 2^24)."""
    L, Hp, Wp = stack.shape
    r = HALF_PATCH
    wx_np, wy_np = _ic_weight_tables()
    d = np.arange(-r, r + 1)
    offs = jnp.asarray((d[:, None] * Wp + d[None, :]).reshape(-1), jnp.int32)
    base = (lvl * Hp + xy[:, 1]) * Wp + xy[:, 0]
    patch = jnp.take(stack.reshape(-1), base[:, None] + offs[None, :],
                     mode="clip")                         # [N, 961]
    m10 = jnp.sum(patch * jnp.asarray(wx_np.reshape(-1))[None], axis=1)
    m01 = jnp.sum(patch * jnp.asarray(wy_np.reshape(-1))[None], axis=1)
    return jnp.arctan2(m01, m10)


def _brief_descriptors_gather(blur_stack: jnp.ndarray, xy: jnp.ndarray,
                              lvl: jnp.ndarray, hw: jnp.ndarray,
                              angle: jnp.ndarray) -> jnp.ndarray:
    """256-bit rBRIEF over the stacked blurred pyramid: one flat gather of
    [N, 512] samples at the integer-rounded rotated pattern offsets.
    Sample coords clip to each keypoint's true level extent `hw` [N, 2]
    (h, w), matching the reference's border clamping.  Returns [N, 32]
    uint8 in OpenCV bit order (bit k of byte j compares pattern pair
    8j+k)."""
    L, Hp, Wp = blur_stack.shape
    pat = jnp.asarray(_PATTERN, jnp.float32)              # [256, 4]
    pxy = jnp.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)  # [512, 2]
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    px, py = pxy[:, 0], pxy[:, 1]
    rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    gx = jnp.clip(xy[:, 0:1] + rx.astype(jnp.int32), 0, hw[:, 1:2] - 1)
    gy = jnp.clip(xy[:, 1:2] + ry.astype(jnp.int32), 0, hw[:, 0:1] - 1)
    idx = (lvl[:, None] * Hp + gy) * Wp + gx
    v = jnp.take(blur_stack.reshape(-1), idx)             # [N, 512]
    va, vb = v[:, :256], v[:, 256:]
    bits = va < vb
    return pack_bits_256(bits)


@functools.lru_cache(maxsize=None)
def _pack_matrix():
    """[256, 16] f32: pack 256 bits into 16 u16 words with one matmul.
    Exact at any matmul precision (0/1 times powers of two, word values
    < 2^16); little-endian u16 -> u8 bitcast yields the OpenCV byte/bit
    order (bit 16w+b == byte 2w+b//8, bit b%8)."""
    P = np.zeros((256, 16), np.float32)
    for p in range(256):
        P[p, p // 16] = float(1 << (p % 16))
    return P


def pack_bits_256(bits: jnp.ndarray) -> jnp.ndarray:
    """[N, 256] bool -> [N, 32] uint8 descriptor bytes via one matmul."""
    w = jnp.dot(bits.astype(jnp.float32), jnp.asarray(_pack_matrix()),
                preferred_element_type=jnp.float32)
    w16 = w.astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(w16, jnp.uint8).reshape(
        bits.shape[0], 32)


# ---------------------------------------------------------------------------
# orientation tables (intensity centroid)
# ---------------------------------------------------------------------------

def _circular_umax() -> np.ndarray:
    """u_max per |dy| of the r=15 circular patch (reference umax table)."""
    r = HALF_PATCH
    umax = np.zeros(r + 1, dtype=np.int64)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(r * r - v * v)))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def _ic_weight_tables():
    """(wx, wy) [31, 31] f32: patch-coordinate weights under the circular
    mask, for gather-based IC angles."""
    r = HALF_PATCH
    umax = _circular_umax()
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = np.abs(xs) <= umax[np.abs(ys)]
    return ((xs * mask).astype(np.float32), (ys * mask).astype(np.float32))


# ---------------------------------------------------------------------------
# full extraction
# ---------------------------------------------------------------------------

def extract_orb(img: jnp.ndarray, cfg: OrbConfig) -> Features:
    """Full ORB extraction for one grayscale f32 [H, W] image (0..255).

    Equivalent of ``ORBextractor::operator()`` (reference
    ``src/ORBextractor.cc:1086-1168``): per-level detect + orient + describe,
    keypoint coords rescaled to level 0.  jit-able; wrap with vmap for the
    multi-agent batched front end.
    """
    L = cfg.n_levels
    Hp, Wp = cfg.level_sizes[0]
    elig_np, lvl_np, scales_np, hws_np = _stack_constants(cfg)

    # Pad every level to the level-0 extent and stack: all per-level work
    # (FAST, NMS, blur, moments, gathers) becomes one batched op each
    # instead of n_levels small dispatches.  The first 3 padded rows/cols
    # hold each level's reflect-101 border so ONE blur over the whole
    # stack is exact in every level's interior: a level's top/left edges
    # coincide with the stack's (where gaussian_blur's own reflect pad
    # applies), and its bottom/right blur windows read the materialized
    # reflected rows.  Consumers never read blurred values outside a
    # level's true extent (taps clamp to h-1/w-1; selection is gated by
    # the eligibility mask), so the remaining zero padding is inert.
    def _rpad(x, lv):
        h, w = cfg.level_sizes[lv]
        ry, rx = min(3, Hp - h), min(3, Wp - w)
        x = jnp.pad(x, ((0, ry), (0, rx)), mode="reflect")
        return jnp.pad(x, ((0, Hp - h - ry), (0, Wp - w - rx)))

    pyr = compute_pyramid(img, cfg)
    stack = jnp.stack([_rpad(pyr[lv], lv) for lv in range(L)])

    score = fast_score_map(stack)
    xy_i, resp, valid = _select_keypoints_stacked(score, cfg)

    lvl = jnp.asarray(lvl_np)
    # Round the blurred image to the integer grid: camera images are
    # uint8, and rounding brings descriptors to near-bit-exact parity with
    # OpenCV ORB (ties in pattern-pair comparisons resolve identically).
    blur_stack = jnp.round(gaussian_blur(stack))
    ang = _ic_angles_gather(stack, xy_i, lvl)
    desc = _brief_descriptors_gather(blur_stack, xy_i, lvl,
                                     jnp.asarray(hws_np), ang)
    xy = xy_i.astype(jnp.float32) * jnp.asarray(scales_np)[:, None]
    level = lvl

    # pad to static capacity
    n = xy.shape[0]
    padn = cfg.capacity - n
    if padn > 0:
        xy = jnp.pad(xy, ((0, padn), (0, 0)))
        level = jnp.pad(level, (0, padn))
        ang = jnp.pad(ang, (0, padn))
        resp = jnp.pad(resp, (0, padn))
        desc = jnp.pad(desc, ((0, padn), (0, 0)))
        valid = jnp.pad(valid, (0, padn))

    return Features(xy=xy, uv=xy, level=level, angle=ang, response=resp,
                    desc=desc, valid=valid)


def with_undistorted(feats: Features, cam) -> Features:
    """Fill the uv (match-space) coords: undistorted for pinhole; raw for
    KB8 (reference keeps mvKeysUn == mvKeys for fisheye)."""
    from mam3slam_tpu.geometry import cameras as _cam

    if cam.kind == _cam.PINHOLE:
        return feats._replace(uv=_cam.undistort_points(cam, feats.xy))
    return feats._replace(uv=feats.xy)

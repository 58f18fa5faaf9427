"""Monocular two-view reconstruction: batched H/F RANSAC + cheirality.

JAX-native replacement for the reference's ``src/TwoViewReconstruction.cc``
(SURVEY.md §2.4): 200-iteration RANSAC over 8-point samples computing
homography and fundamental hypotheses *in parallel*, model selection by
score ratio, motion-and-structure recovery with cheirality checks.

Design: instead of the reference's sequential RANSAC loop, all 200
samples are drawn up front and all 200 H- and F-hypotheses are estimated
with one batched SVD and scored with one [R, N] fused reduction.  Motion
recovery evaluates all candidate (R, t) hypotheses (4 from E, 8 from H via
the Faugeras decomposition) with one batched triangulation + cheirality
count, then selects the winner by the reference's uniqueness criteria —
no data-dependent control flow, so the whole initializer jits.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991  # both models scored with the same cap (reference)


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray          # [] bool
    R21: jnp.ndarray         # [3, 3] rotation frame1 -> frame2
    t21: jnp.ndarray         # [3] unit-norm translation
    points3d: jnp.ndarray    # [N, 3] in frame-1 coords
    is_triangulated: jnp.ndarray  # [N] bool
    used_homography: jnp.ndarray  # [] bool


def _normalize(uv: jnp.ndarray, valid: jnp.ndarray):
    """Hartley normalization (mean 0, mean abs dev 1) over valid points."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w[:, None], axis=0) / n
    d = jnp.abs(uv - mean) * w[:, None]
    md = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(md, 1e-8)
    uvn = (uv - mean) * s
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return uvn, T


def _dlt_F(p1: jnp.ndarray, p2: jnp.ndarray, w=None) -> jnp.ndarray:
    """8-point fundamental from [S, P, 2] normalized samples -> [S, 3, 3].
    Optional per-row weights ``w [S, P]`` enable all-inlier refinement."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                  axis=-1)  # [S, P, 9]
    if w is not None:
        A = A * w[..., None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[..., -1, :].reshape(-1, 3, 3)
    # enforce rank 2
    u, s, vt2 = jnp.linalg.svd(F)
    s = s.at[..., 2].set(0.0)
    return u @ (s[..., :, None] * vt2)


def _dlt_H(p1: jnp.ndarray, p2: jnp.ndarray, w=None) -> jnp.ndarray:
    """Normalized DLT homography from [S, P, 2] samples -> [S, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # [S, 2P, 9]
    if w is not None:
        A = A * jnp.concatenate([w, w], axis=-1)[..., None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[..., -1, :].reshape(-1, 3, 3)


def _score_F(F: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray,
             valid: jnp.ndarray, sigma: float):
    """Symmetric epipolar transfer score (reference CheckFundamental)."""
    o = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, o], axis=-1)  # [N, 3]
    x2 = jnp.concatenate([uv2, o], axis=-1)
    inv_s2 = 1.0 / (sigma * sigma)

    l2 = jnp.einsum("sij,nj->sni", F, x1)  # lines in image 2
    num2 = jnp.einsum("ni,sni->sn", x2, l2)
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    chi2_1 = (num2 * num2 / jnp.maximum(den2, 1e-12)) * inv_s2

    l1 = jnp.einsum("sji,nj->sni", F, x2)  # lines in image 1
    num1 = jnp.einsum("ni,sni->sn", x1, l1)
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    chi2_2 = (num1 * num1 / jnp.maximum(den1, 1e-12)) * inv_s2

    in1 = chi2_1 < CHI2_F
    in2 = chi2_2 < CHI2_F
    inlier = in1 & in2 & valid[None, :]
    score = (jnp.where(in1 & valid[None, :], SCORE_CAP - chi2_1, 0.0)
             + jnp.where(in2 & valid[None, :], SCORE_CAP - chi2_2, 0.0))
    return jnp.sum(score, axis=-1), inlier


def _score_H(H: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray,
             valid: jnp.ndarray, sigma: float):
    """Symmetric transfer score for H (reference CheckHomography)."""
    o = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, o], axis=-1)
    x2 = jnp.concatenate([uv2, o], axis=-1)
    inv_s2 = 1.0 / (sigma * sigma)
    Hinv = jnp.linalg.inv(H)

    p12 = jnp.einsum("sij,nj->sni", H, x1)
    p12 = p12[..., :2] / jnp.where(
        jnp.abs(p12[..., 2:3]) < 1e-12, 1e-12, p12[..., 2:3])
    chi2_1 = jnp.sum((uv2[None] - p12) ** 2, axis=-1) * inv_s2

    p21 = jnp.einsum("sij,nj->sni", Hinv, x2)
    p21 = p21[..., :2] / jnp.where(
        jnp.abs(p21[..., 2:3]) < 1e-12, 1e-12, p21[..., 2:3])
    chi2_2 = jnp.sum((uv1[None] - p21) ** 2, axis=-1) * inv_s2

    in1 = chi2_1 < CHI2_H
    in2 = chi2_2 < CHI2_H
    inlier = in1 & in2 & valid[None, :]
    score = (jnp.where(in1 & valid[None, :], SCORE_CAP - chi2_1, 0.0)
             + jnp.where(in2 & valid[None, :], SCORE_CAP - chi2_2, 0.0))
    return jnp.sum(score, axis=-1), inlier


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray,
                    uv2: jnp.ndarray) -> jnp.ndarray:
    """Batched DLT triangulation (reference GeometricTools::Triangulate).

    P1, P2: [..., 3, 4] projection matrices; uv1, uv2: [..., 2].
    Returns [..., 3] world points.
    """
    rows = [
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [..., 4, 4]
    _, _, vt = jnp.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)


def _check_rt(R: jnp.ndarray, t: jnp.ndarray, uv1: jnp.ndarray,
              uv2: jnp.ndarray, valid: jnp.ndarray, K: jnp.ndarray,
              sigma: float):
    """Cheirality + reprojection validation of one (R, t) hypothesis over
    all matches (reference CheckRT).  Batched over hypotheses via vmap.

    Returns (n_good, parallax_deg, points3d [N, 3], good_mask [N])."""
    th2 = 4.0 * sigma * sigma
    P1 = jnp.concatenate([K, jnp.zeros((3, 1))], axis=1)
    P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
    X = triangulate_dlt(jnp.broadcast_to(P1, uv1.shape[:-1] + (3, 4)),
                        jnp.broadcast_to(P2, uv1.shape[:-1] + (3, 4)),
                        uv1, uv2)  # [N, 3] in frame-1
    finite = jnp.all(jnp.isfinite(X), axis=-1)
    X = jnp.where(finite[:, None], X, 0.0)

    C1 = jnp.zeros(3)
    C2 = -R.T @ t
    n1 = X - C1
    n2 = X - C2
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2 = jnp.linalg.norm(n2, axis=-1)
    cos_par = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(d1 * d2, 1e-12)

    z1 = X[:, 2]
    X2 = X @ R.T + t
    z2 = X2[:, 2]

    uv1p = (X @ K.T)
    uv1p = uv1p[:, :2] / jnp.where(jnp.abs(uv1p[:, 2:3]) < 1e-12, 1e-12,
                                   uv1p[:, 2:3])
    uv2p = (X2 @ K.T)
    uv2p = uv2p[:, :2] / jnp.where(jnp.abs(uv2p[:, 2:3]) < 1e-12, 1e-12,
                                   uv2p[:, 2:3])
    e1 = jnp.sum((uv1p - uv1) ** 2, axis=-1)
    e2 = jnp.sum((uv2p - uv2) ** 2, axis=-1)

    good = (valid & finite & (cos_par < 0.99998) & (z1 > 0) & (z2 > 0)
            & (e1 < th2) & (e2 < th2))
    n_good = jnp.sum(good)

    # parallax statistic: ~50th best (reference takes min(50, size-1)-th)
    par_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_par, -1.0, 1.0)))
    par_sorted = jnp.sort(jnp.where(good, par_deg, 0.0))[::-1]
    k = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    parallax = par_sorted[k]
    return n_good, parallax, X, good


def _decompose_E(E: jnp.ndarray):
    """E -> 4 (R, t) hypotheses."""
    u, _, vt = jnp.linalg.svd(E)
    # ensure proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_H(H: jnp.ndarray, K: jnp.ndarray):
    """Faugeras-Lustman decomposition of a homography -> 8 (R, t)."""
    A = jnp.linalg.inv(K) @ H @ K
    u, d, vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    x1s = jnp.array([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.array([1.0, -1.0, 1.0, -1.0]) * aux3

    Rs, ts = [], []
    # case d' = d2
    stheta_base = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
            (d1 + d3) * d2, 1e-12)
    ctheta = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sign_s = jnp.array([1.0, -1.0, -1.0, 1.0])
    for i in range(4):
        st = sign_s[i] * stheta_base
        Rp = jnp.array([[0.0, 0.0, 0.0]] * 3)
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        Rp = Rp.at[0, 0].set(ctheta).at[0, 2].set(-st)
        Rp = Rp.at[2, 0].set(st).at[2, 2].set(ctheta)
        R = s * u @ Rp @ vt
        tp = jnp.array([1.0, 0.0, -1.0]) * jnp.stack(
            [x1s[i], jnp.asarray(0.0), x3s[i]]) * (d1 - d3)
        t = u @ tp
        Rs.append(R)
        ts.append(t / jnp.maximum(jnp.linalg.norm(t), 1e-12))
    # case d' = -d2
    sphi_base = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum(
            (d1 - d3) * d2, 1e-12)
    cphi = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for i in range(4):
        sp = sign_s[i] * sphi_base
        Rp = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
        Rp = Rp.at[0, 0].set(cphi).at[0, 2].set(sp)
        Rp = Rp.at[2, 0].set(sp).at[2, 2].set(-cphi)
        R = s * u @ Rp @ vt
        tp = jnp.stack([x1s[i], jnp.asarray(0.0), x3s[i]]) * (d1 + d3)
        t = u @ tp
        Rs.append(R)
        ts.append(t / jnp.maximum(jnp.linalg.norm(t), 1e-12))
    return jnp.stack(Rs), jnp.stack(ts)


def reconstruct_two_views(uv1: jnp.ndarray, uv2: jnp.ndarray,
                          valid: jnp.ndarray, K: jnp.ndarray,
                          key: jnp.ndarray, sigma: float = 1.0,
                          n_ransac: int = 200,
                          min_triangulated: int = 50,
                          min_parallax: float = 1.0) -> TwoViewResult:
    """Full monocular initialization from matched pixel pairs.

    uv1/uv2: [N, 2] matched keypoints (row i of uv1 matches row i of uv2 —
    callers compact match results into this form); valid: [N] mask;
    K: [3, 3] ideal intrinsics (undistorted match space).

    Mirrors ``TwoViewReconstruction::Reconstruct`` semantics: H and F
    hypotheses RANSAC'd in parallel, winner by score ratio RH > 0.5,
    motion recovered with cheirality + parallax + uniqueness gates.
    """
    n = uv1.shape[0]
    w = valid.astype(jnp.float32)
    n_valid = jnp.sum(w).astype(jnp.int32)

    # --- sample RANSAC minimal sets from valid matches
    order = jnp.argsort(~valid)  # valid first
    probe = jax.random.uniform(key, (n_ransac, 8))
    sample_pos = (probe * jnp.maximum(n_valid, 8).astype(jnp.float32)
                  ).astype(jnp.int32)
    samples = order[sample_pos]  # [R, 8]

    uvn1, T1 = _normalize(uv1, valid)
    uvn2, T2 = _normalize(uv2, valid)

    p1 = uvn1[samples]  # [R, 8, 2]
    p2 = uvn2[samples]

    Fn = _dlt_F(p1, p2)
    F = jnp.einsum("ij,sjk,kl->sil", T2.T, Fn, T1)  # denormalize
    Hn = _dlt_H(p1, p2)
    H = jnp.einsum("ij,sjk,kl->sil", jnp.linalg.inv(T2), Hn, T1)

    scores_F, inliers_F = _score_F(F, uv1, uv2, valid, sigma)
    scores_H, inliers_H = _score_H(H, uv1, uv2, valid, sigma)

    iF = jnp.argmax(scores_F)
    iH = jnp.argmax(scores_H)
    SF, SH = scores_F[iF], scores_H[iH]
    inF, inH = inliers_F[iF], inliers_H[iH]

    # all-inlier refinement of the winning models (one weighted DLT each;
    # the minimal 8-point estimate alone leaves several degrees of
    # translation-direction error at realistic noise)
    bestF = _dlt_F(uvn1[None], uvn2[None], inF[None].astype(uvn1.dtype))[0]
    bestF = T2.T @ bestF @ T1
    bestH = _dlt_H(uvn1[None], uvn2[None], inH[None].astype(uvn1.dtype))[0]
    bestH = jnp.linalg.inv(T2) @ bestH @ T1
    sF2, inF2 = _score_F(bestF[None], uv1, uv2, valid, sigma)
    sH2, inH2 = _score_H(bestH[None], uv1, uv2, valid, sigma)
    # keep the refined model only if it did not degrade
    use_refined_F = sF2[0] >= SF
    bestF = jnp.where(use_refined_F, bestF, F[iF])
    inF = jnp.where(use_refined_F, inF2[0], inF)
    SF = jnp.maximum(sF2[0], SF)
    use_refined_H = sH2[0] >= SH
    bestH = jnp.where(use_refined_H, bestH, H[iH])
    inH = jnp.where(use_refined_H, inH2[0], inH)
    SH = jnp.maximum(sH2[0], SH)

    RH = SH / jnp.maximum(SH + SF, 1e-12)
    prefer_H = RH > 0.5  # reference threshold (TwoViewReconstruction.cc:119)

    # --- candidate motions: 8 from H, 4 from E; evaluate all 12 at once
    E = K.T @ bestF @ K
    Rs_E, ts_E = _decompose_E(E)
    Rs_H, ts_H = _decompose_H(bestH, K)
    Rs = jnp.concatenate([Rs_E, Rs_H])   # [12, 3, 3]
    ts = jnp.concatenate([ts_E, ts_H])
    from_H = jnp.concatenate([jnp.zeros(4, bool), jnp.ones(8, bool)])
    # each hypothesis is validated against ITS model's RANSAC inlier set
    hyp_valid = jnp.where(from_H[:, None], inH[None, :], inF[None, :])

    n_good, parallax, X, good = jax.vmap(
        lambda R, t, v: _check_rt(R, t, uv1, uv2, v, K, sigma)
    )(Rs, ts, hyp_valid)

    def group_gate(is_h: bool):
        """Reference ReconstructF/H acceptance: a unique clear winner that
        explains >=90% of the model's inliers with enough parallax."""
        gmask = from_H == is_h
        gn = jnp.where(gmask, n_good, -1)
        max_good = jnp.max(gn)
        best = jnp.argmax(gn)
        n_similar = jnp.sum(gn > 0.7 * max_good)
        n_inl = jnp.sum(inH if is_h else inF)
        min_good = jnp.maximum((0.9 * n_inl).astype(jnp.int32),
                               min_triangulated)
        ok = ((max_good >= min_good) & (n_similar == 1)
              & (parallax[best] > min_parallax))
        return ok, best

    ok_F, best_F = group_gate(False)
    ok_H, best_H_i = group_gate(True)

    # Primary model per RH ratio; strict-gated fallback to the other model
    # (we already validated all 12 hypotheses, so this is free and rescues
    # e.g. exactly-planar scenes where the degenerate F family outscores H).
    primary_ok = jnp.where(prefer_H, ok_H, ok_F)
    use_H = jnp.where(primary_ok, prefer_H, ok_H)
    ok = primary_ok | ok_F | ok_H
    best = jnp.where(use_H, best_H_i, best_F)

    return TwoViewResult(
        ok=ok,
        R21=Rs[best],
        t21=ts[best],
        points3d=X[best],
        is_triangulated=good[best] & (n_good[best] > 0),
        used_homography=use_H,
    )

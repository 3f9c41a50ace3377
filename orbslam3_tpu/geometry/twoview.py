"""Two-view monocular initialization: batched RANSAC of F (8-pt) and H
(DLT), model selection, motion recovery and cheirality checks.

Parity target: reference src/TwoViewReconstruction.cc —
  * 200 RANSAC iterations over 8-point samples for BOTH models (:150-230);
  * normalization by mean absolute deviation (:751+ Normalize);
  * scoring: symmetric transfer chi2; F: th=3.841, score term 5.991-chi2;
    H: th=5.991 both directions (:308-472);
  * selection: RH = SH/(SH+SF) > 0.40 -> H else F (:111-125);
  * ReconstructF: E = K^T F K, 4 motions, CheckRT with reproj th 4*sigma2,
    cheirality cosParallax<0.99998, winner needs maxGood >= max(0.9N, 50)
    and no second hypothesis >0.7*maxGood, parallax > 1 deg (:474-580);
  * ReconstructH: Faugeras 8-motion decomposition, winner needs
    secondBest < 0.75*best, parallax >= 1, best > 50 and > 0.9N (:585-747).

Design: the reference runs 200 iterations sequentially in 2 threads;
here all 200 hypotheses for both models are evaluated in parallel
(vmap over hypothesis, broadcast over matches) — one fused program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie, triangulate

_HI = jax.lax.Precision.HIGHEST

RANSAC_ITERS = 200
SAMPLE_SIZE = 8
CHI2_F = 3.841
CHI2_SCORE = 5.991
CHI2_H = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
COS_PARALLAX_MAX = 0.99998


class TwoViewResult(NamedTuple):
    success: jnp.ndarray       # () bool
    R21: jnp.ndarray           # (3,3) pose of cam2 wrt cam1 (x2 = R x1 + t)
    t21: jnp.ndarray           # (3,)
    points3d: jnp.ndarray      # (N,3) in cam1 frame
    triangulated: jnp.ndarray  # (N,) bool
    used_homography: jnp.ndarray  # () bool


def _normalize(pts: jnp.ndarray, w: jnp.ndarray):
    """Mean/mean-absolute-deviation normalization (reference Normalize)."""
    wsum = jnp.sum(w) + 1e-9
    mean = jnp.sum(pts * w[:, None], axis=0) / wsum
    d = jnp.abs(pts - mean)
    mdev = jnp.sum(d * w[:, None], axis=0) / wsum
    s = 1.0 / (mdev + 1e-9)
    T = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return (pts - mean) * s, T


def _fit_F(p1: jnp.ndarray, p2: jnp.ndarray,
           w: jnp.ndarray | None = None) -> jnp.ndarray:
    """Normalized 8-point algorithm: p1, p2 (M, 2), optional row weights."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)  # (M, 9)
    if w is not None:
        A = A * w[:, None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[-1].reshape(3, 3)
    # rank-2 enforcement
    U, D, Vt2 = jnp.linalg.svd(F)
    D = D.at[2].set(0.0)
    return (U * D[None, :]) @ Vt2


def _fit_H(p1: jnp.ndarray, p2: jnp.ndarray,
           w: jnp.ndarray | None = None) -> jnp.ndarray:
    """DLT homography (reference ComputeH21), optional row weights."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2M, 9)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _score_F(F21, p1, p2, valid, sigma2: float):
    """Symmetric epipolar chi2 scoring (reference CheckFundamental)."""
    ones = jnp.ones((p1.shape[0], 1))
    h1 = jnp.concatenate([p1, ones], axis=1)
    h2 = jnp.concatenate([p2, ones], axis=1)
    l2 = jnp.matmul(h1, F21.T, precision=_HI)  # epiline in img2
    l1 = jnp.matmul(h2, F21, precision=_HI)   # epiline in img1
    inv_s2 = 1.0 / sigma2
    d2 = jnp.sum(l2 * h2, axis=1) ** 2 / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = jnp.sum(l1 * h1, axis=1) ** 2 / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    chi1 = d2 * inv_s2
    chi2_ = d1 * inv_s2
    ok = (chi1 <= CHI2_F) & (chi2_ <= CHI2_F) & valid
    score = jnp.sum(jnp.where(valid & (chi1 <= CHI2_F), CHI2_SCORE - chi1, 0.0) +
                    jnp.where(valid & (chi2_ <= CHI2_F), CHI2_SCORE - chi2_, 0.0))
    return score, ok


def _score_H(H21, p1, p2, valid, sigma2: float):
    """Symmetric transfer error scoring (reference CheckHomography)."""
    H12 = jnp.linalg.inv(H21 + jnp.eye(3) * 1e-12)
    ones = jnp.ones((p1.shape[0], 1))
    h1 = jnp.concatenate([p1, ones], axis=1)
    h2 = jnp.concatenate([p2, ones], axis=1)
    q2 = jnp.matmul(h1, H21.T, precision=_HI)
    q2 = q2[:, :2] / (q2[:, 2:3] + 1e-12)
    q1 = jnp.matmul(h2, H12.T, precision=_HI)
    q1 = q1[:, :2] / (q1[:, 2:3] + 1e-12)
    inv_s2 = 1.0 / sigma2
    chi1 = jnp.sum((p2 - q2) ** 2, axis=1) * inv_s2
    chi2_ = jnp.sum((p1 - q1) ** 2, axis=1) * inv_s2
    ok = (chi1 <= CHI2_H) & (chi2_ <= CHI2_H) & valid
    score = jnp.sum(jnp.where(valid & (chi1 <= CHI2_H), CHI2_H - chi1, 0.0) +
                    jnp.where(valid & (chi2_ <= CHI2_H), CHI2_H - chi2_, 0.0))
    return score, ok


def _check_rt(R, t, p1, p2, inliers, K4, sigma2: float):
    """Cheirality + reprojection check of one motion hypothesis
    (reference CheckRT).  Returns (nGood, parallax_deg, X (N,3), good)."""
    n = p1.shape[0]
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    ray1 = jnp.stack([(p1[:, 0] - cx) / fx, (p1[:, 1] - cy) / fy,
                      jnp.ones(n)], axis=1)
    ray2 = jnp.stack([(p2[:, 0] - cx) / fx, (p2[:, 1] - cy) / fy,
                      jnp.ones(n)], axis=1)
    I = jnp.broadcast_to(jnp.eye(3), (n, 3, 3))
    z = jnp.zeros((n, 3))
    X = triangulate.triangulate_dlt(ray1, ray2, I, z,
                                    jnp.broadcast_to(R, (n, 3, 3)),
                                    jnp.broadcast_to(t, (n, 3)))
    finite = jnp.all(jnp.isfinite(X), axis=1)
    O2 = -jnp.matmul(R.T, t, precision=_HI)
    n1 = X
    n2 = X - O2
    d1 = jnp.linalg.norm(n1, axis=1)
    d2 = jnp.linalg.norm(n2, axis=1)
    cos_par = jnp.sum(n1 * n2, axis=1) / (d1 * d2 + 1e-12)
    Xc2 = jnp.matmul(X, R.T, precision=_HI) + t
    far = cos_par >= COS_PARALLAX_MAX  # "infinite" points skip depth check
    depth_ok = ((X[:, 2] > 0) | far) & ((Xc2[:, 2] > 0) | far)
    e1 = jnp.stack([fx * X[:, 0] / (X[:, 2] + 1e-12) + cx,
                    fy * X[:, 1] / (X[:, 2] + 1e-12) + cy], axis=1) - p1
    e2 = jnp.stack([fx * Xc2[:, 0] / (Xc2[:, 2] + 1e-12) + cx,
                    fy * Xc2[:, 1] / (Xc2[:, 2] + 1e-12) + cy], axis=1) - p2
    th2 = 4.0 * sigma2
    reproj_ok = (jnp.sum(e1 ** 2, axis=1) <= th2) & \
                (jnp.sum(e2 ** 2, axis=1) <= th2)
    good_count = inliers & finite & depth_ok & reproj_ok
    n_good = jnp.sum(good_count.astype(jnp.int32))
    good = good_count & (cos_par < COS_PARALLAX_MAX)
    # parallax = acos of the 50th smallest cosParallax among good
    cp = jnp.where(good_count, cos_par, 2.0)
    cp_sorted = jnp.sort(cp)
    idx = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    parallax = jnp.degrees(jnp.arccos(jnp.clip(cp_sorted[idx], -1.0, 1.0)))
    parallax = jnp.where(n_good > 0, parallax, 0.0)
    return n_good, parallax, X, good


def _decompose_E(E):
    U, _, Vt = jnp.linalg.svd(E)
    t = U[:, 2]
    t = t / (jnp.linalg.norm(t) + 1e-12)
    W = jnp.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    R1 = jnp.matmul(jnp.matmul(U, W, precision=_HI), Vt, precision=_HI)
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = jnp.matmul(jnp.matmul(U, W.T, precision=_HI), Vt, precision=_HI)
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _homography_motions(A):
    """Faugeras 8-motion decomposition of A = K^-1 H K (reference
    ReconstructH).  Returns (Rs (8,3,3), ts (8,3), degenerate())."""
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    degenerate = (d1 / (d2 + 1e-12) < 1.00001) | (d2 / (d3 + 1e-12) < 1.00001)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), 0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), 0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])
    Rs, ts = [], []
    # case d' = d2
    aux_st = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) \
        / ((d1 + d3) * d2 + 1e-12)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    sts = jnp.array([aux_st, -aux_st, -aux_st, aux_st])
    for i in range(4):
        Rp = jnp.array([[1.0, 0, 0], [0, 1, 0], [0, 0, 1]])
        Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-sts[i]) \
               .at[2, 0].set(sts[i]).at[2, 2].set(ct)
        Rs.append(s * jnp.matmul(jnp.matmul(U, Rp, precision=_HI), Vt, precision=_HI))
        tp = jnp.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        tv = jnp.matmul(U, tp, precision=_HI)
        ts.append(tv / (jnp.linalg.norm(tv) + 1e-12))
    # case d' = -d2
    aux_sp = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) \
        / ((d1 - d3) * d2 + 1e-12)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + 1e-12)
    sps = jnp.array([aux_sp, -aux_sp, -aux_sp, aux_sp])
    for i in range(4):
        Rp = jnp.zeros((3, 3))
        Rp = Rp.at[0, 0].set(cp).at[0, 2].set(sps[i]).at[1, 1].set(-1.0) \
               .at[2, 0].set(sps[i]).at[2, 2].set(-cp)
        Rs.append(s * jnp.matmul(jnp.matmul(U, Rp, precision=_HI), Vt, precision=_HI))
        tp = jnp.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        tv = jnp.matmul(U, tp, precision=_HI)
        ts.append(tv / (jnp.linalg.norm(tv) + 1e-12))
    return jnp.stack(Rs), jnp.stack(ts), degenerate


def reconstruct(xy1: jnp.ndarray, xy2: jnp.ndarray, valid: jnp.ndarray,
                K4: jnp.ndarray, key: jnp.ndarray,
                sigma: float = 1.0) -> TwoViewResult:
    """Full two-view reconstruction from matched keypoints.

    xy1, xy2: (N, 2) matched pixel coords (row i of xy1 matches row i of
    xy2); valid: (N,) mask.  K4 = [fx, fy, cx, cy].
    """
    n = xy1.shape[0]
    sigma2 = sigma * sigma

    # --- normalized coordinates ------------------------------------------
    p1n, T1 = _normalize(xy1, valid.astype(jnp.float32))
    p2n, T2 = _normalize(xy2, valid.astype(jnp.float32))

    # --- RANSAC sampling: (ITERS, 8) indices among valid matches ---------
    w = valid.astype(jnp.float32) + 1e-9
    idx = jax.random.categorical(
        key, jnp.log(w)[None, :].repeat(RANSAC_ITERS * SAMPLE_SIZE, 0)
    ).reshape(RANSAC_ITERS, SAMPLE_SIZE)

    s1 = p1n[idx]  # (I, 8, 2)
    s2 = p2n[idx]

    Fn = jax.vmap(_fit_F)(s1, s2)
    Hn = jax.vmap(_fit_H)(s1, s2)
    T2t = T2.T
    F_all = jnp.einsum("ij,njk,kl->nil", T2t, Fn, T1, precision=_HI)
    H_all = jnp.einsum("ij,njk,kl->nil",
                       jnp.linalg.inv(T2), Hn, T1, precision=_HI)

    scF, okF = jax.vmap(lambda F: _score_F(F, xy1, xy2, valid, sigma2))(F_all)
    scH, okH = jax.vmap(lambda H: _score_H(H, xy1, xy2, valid, sigma2))(H_all)

    bi_F = jnp.argmax(scF)
    bi_H = jnp.argmax(scH)
    SF, inlF = scF[bi_F], okF[bi_F]
    SH, inlH = scH[bi_H], okH[bi_H]

    # refit on all inliers of the winning hypothesis (the reference keeps
    # the minimal-sample model; the all-inlier DLT refit costs one more SVD
    # and tightens the recovered motion — strict accuracy improvement)
    F21 = jnp.einsum("ij,jk,kl->il", T2t,
                     _fit_F(p1n, p2n, inlF.astype(jnp.float32)), T1,
                     precision=_HI)
    H21 = jnp.einsum("ij,jk,kl->il", jnp.linalg.inv(T2),
                     _fit_H(p1n, p2n, inlH.astype(jnp.float32)), T1,
                     precision=_HI)
    # rescore with the refit models so inlier sets stay consistent
    SF2, inlF2 = _score_F(F21, xy1, xy2, valid, sigma2)
    SH2, inlH2 = _score_H(H21, xy1, xy2, valid, sigma2)
    keepF = SF2 >= SF
    keepH = SH2 >= SH
    F21 = jnp.where(keepF, F21, jnp.einsum("ij,jk,kl->il", T2t, Fn[bi_F], T1,
                                           precision=_HI))
    H21 = jnp.where(keepH, H21,
                    jnp.einsum("ij,jk,kl->il", jnp.linalg.inv(T2), Hn[bi_H],
                               T1, precision=_HI))
    SF = jnp.maximum(SF, SF2)
    SH = jnp.maximum(SH, SH2)
    inlF = jnp.where(keepF, inlF2, inlF)
    inlH = jnp.where(keepH, inlH2, inlH)

    RH = SH / (SH + SF + 1e-12)
    use_H = RH > 0.40

    # --- motion recovery --------------------------------------------------
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    K = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    K = K.at[0, 0].set(fx).at[1, 1].set(fy).at[0, 2].set(cx).at[1, 2].set(cy)

    # F path: 4 hypotheses
    E = jnp.matmul(jnp.matmul(K.T, F21, precision=_HI), K, precision=_HI)
    Rf1, Rf2, tf = _decompose_E(E)
    RsF = jnp.stack([Rf1, Rf2, Rf1, Rf2])
    tsF = jnp.stack([tf, tf, -tf, -tf])

    # H path: 8 hypotheses
    A = jnp.matmul(jnp.matmul(jnp.linalg.inv(K), H21, precision=_HI), K, precision=_HI)
    RsH, tsH, h_degenerate = _homography_motions(A)

    inliers = jnp.where(use_H, inlH, inlF)
    Rs = jnp.concatenate([RsF, RsH])     # (12,3,3)
    ts = jnp.concatenate([tsF, tsH])
    hyp_on = jnp.where(use_H,
                       jnp.arange(12) >= 4,
                       jnp.arange(12) < 4)

    ng, par, Xs, goods = jax.vmap(
        lambda R, t: _check_rt(R, t, xy1, xy2, inliers, K4, sigma2))(Rs, ts)
    ng = jnp.where(hyp_on, ng, -1)
    best = jnp.argmax(ng)
    n_best = ng[best]
    ng2 = ng.at[best].set(-1)
    n_second = jnp.max(ng2)
    N_inl = jnp.sum(inliers.astype(jnp.int32))
    min_good = jnp.maximum((0.9 * N_inl).astype(jnp.int32), MIN_TRIANGULATED)

    # acceptance per reference: F needs nsimilar<=1 (0.7 rule); H needs
    # second < 0.75*best; both need parallax and counts
    n_similar = jnp.sum((ng > 0.7 * n_best).astype(jnp.int32))
    ok_F = (n_best >= min_good) & (n_similar <= 1) & \
           (par[best] > MIN_PARALLAX_DEG)
    ok_H = (n_second < 0.75 * n_best) & (par[best] >= MIN_PARALLAX_DEG) & \
           (n_best > MIN_TRIANGULATED) & (n_best > 0.9 * N_inl) & \
           ~h_degenerate
    success = jnp.where(use_H, ok_H, ok_F)

    return TwoViewResult(
        success=success,
        R21=lie.normalize_rotation(Rs[best]),
        t21=ts[best],
        points3d=Xs[best],
        triangulated=goods[best] & success,
        used_homography=use_H)

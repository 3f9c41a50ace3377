"""Robust PnP: batched RANSAC pose-from-3D-2D correspondences.

Parity target: reference MLPnPsolver (src/MLPnPsolver.cpp — RANSAC
maximum-likelihood PnP with nullspace bearing parametrization; params
prob .95, minInliers 50, maxIts 300, minSet 12 at src/Tracking.cc:839).

Design: the MLPnP nullspace machinery exists to squeeze accuracy out
of a scalar CPU solver.  Here every RANSAC hypothesis is a linear DLT
P6P solve (SVD of the stacked projection equations), all hypotheses
evaluated in parallel, followed by the robust IRLS pose optimizer on the
winning inlier set — same contract (pose + inliers from 2D-3D matches,
no prior), simpler per-hypothesis math, massively parallel.

The ML part of MLPnP — per-observation measurement covariances
(MLPnPsolver.h:63-73 builds nullspace residuals weighted by the bearing
covariance propagated from the pixel covariance) — is carried by
`inv_sigma2`: the per-keypoint inverse pixel variance (octave noise
model, sigma = 1.2^octave px).  For a central camera with isotropic
per-pixel noise, chi2-weighting the pixel residual by 1/sigma2 is the
same maximum-likelihood objective MLPnP expresses in bearing tangent
space; it enters both hypothesis scoring and the IRLS refinement.
Equivalence under the reference's RANSAC regime (prob .95, minInliers
50, maxIts 300, minSet 12, 30-50% outliers) is exercised by
tests/test_pnp.py::TestReferenceRegime.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie
from ..solver import pose_opt

_HI = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    success: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def _dlt_p6p(X: jnp.ndarray, xn: jnp.ndarray):
    """Linear pose from >=6 points: X (S,3) world, xn (S,2) normalized
    image coords.  Hartley-normalized DLT; R orthogonalized."""
    S = X.shape[0]
    # normalize 3D points: centroid -> 0, RMS -> sqrt(3)
    c = jnp.mean(X, axis=0)
    Xc_ = X - c
    rms = jnp.sqrt(jnp.mean(jnp.sum(Xc_ ** 2, axis=1)) + 1e-12)
    s = jnp.sqrt(3.0) / rms
    Xn = Xc_ * s
    zeros = jnp.zeros((S, 4))
    Xh = jnp.concatenate([Xn, jnp.ones((S, 1))], axis=1)
    r1 = jnp.concatenate([Xh, zeros, -xn[:, 0:1] * Xh], axis=1)
    r2 = jnp.concatenate([zeros, Xh, -xn[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2S, 12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    Pn = Vt[-1].reshape(3, 4)
    # denormalize: X_norm = s (X - c)  =>  P = Pn @ [[sI, -s c], [0, 1]]
    M = Pn[:, :3] * s
    p3 = Pn[:, 3] - Pn[:, :3] @ (s * c)
    det = jnp.linalg.det(M)
    scale = jnp.sign(det) * jnp.cbrt(jnp.abs(det) + 1e-20)
    scale = jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    M = M / scale
    p3 = p3 / scale
    # M is a raw (scale-removed) DLT estimate — not near-orthogonal, so it
    # needs the exact SVD projection, not the Newton polar step
    R = lie.normalize_rotation_svd(M)
    return R, p3


def solve_pnp(X: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
              cam_model: str, cam_params, key,
              iterations: int = 256, sample: int = 12,
              chi2_th: float = 5.991, min_inliers: int = 30,
              inv_sigma2=None) -> PnPResult:
    """X (N,3) world points matched to uv (N,2) pixels; RANSAC + refine.

    sample=12 matches the reference MLPnP minSet (a 12-point DLT averages
    pixel noise down enough for reliable hypothesis scoring); hypotheses
    are scored with a loosened gate (4x chi2) so near-miss poses still
    collect their true support, then the IRLS pose optimizer re-selects
    inliers at the strict threshold.

    `inv_sigma2` (N,): per-observation inverse pixel variance — the
    measurement covariance of MLPnP's ML objective (octave noise model);
    defaults to 1.
    """
    n = X.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones(n)
    rays = cameras.unproject(cam_model, cam_params, uv)
    xn = rays[:, :2] / rays[:, 2:3]

    w = valid.astype(jnp.float32) + 1e-9
    # split the hypothesis budget between `sample`-point minimal sets
    # (12 by default — noise-averaging DLT, wins scoring when outlier
    # rates are low) and lean 7-point sets whose all-inlier probability
    # survives 40-50% contamination (0.5^7 vs 0.5^12 per draw) — at the
    # reference's fixed maxIts=300 budget a 12-only sampler goes blind
    # above ~40% outliers
    lean = max(min(7, sample), 6)
    n12 = iterations // 2
    n7 = iterations - n12
    k1, k2 = jax.random.split(key)
    idx = jax.random.categorical(
        k1, jnp.log(w)[None, :].repeat(n12 * sample, 0)
    ).reshape(n12, sample)
    idx7 = jax.random.categorical(
        k2, jnp.log(w)[None, :].repeat(n7 * lean, 0)
    ).reshape(n7, lean)

    Rs, ts = jax.vmap(lambda s: _dlt_p6p(X[s], xn[s]))(idx)
    Rs7, ts7 = jax.vmap(lambda s: _dlt_p6p(X[s], xn[s]))(idx7)
    Rs = jnp.concatenate([Rs, Rs7])
    ts = jnp.concatenate([ts, ts7])

    def score(R, t, th):
        Xc = lie.se3_apply(R, t, X)
        e = uv - cameras.project(cam_model, cam_params, Xc)
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        ok = (chi2 < th) & valid & (Xc[:, 2] > 0.01)
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, inl = jax.vmap(lambda R, t: score(R, t, 4.0 * chi2_th))(Rs, ts)
    best = jnp.argmax(counts)
    res = pose_opt.pose_optimization(
        Rs[best], ts[best], X, uv, inv_sigma2, inl[best],
        cam_model, cam_params, rounds=3, its_per_round=6,
        chi2_th=chi2_th)
    return PnPResult(success=res.n_inliers >= min_inliers,
                     R=res.R, t=res.t, inliers=res.inliers,
                     n_inliers=res.n_inliers)

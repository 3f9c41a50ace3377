"""Sim(3) RANSAC between two matched 3D point sets (loop closure).

Parity target: reference Sim3Solver (src/Sim3Solver.cc) — iterate (:131)
draws 3-point samples, ComputeSim3 (:311) is Horn's closed-form absolute
orientation with scale, inliers checked by reprojection in BOTH cameras
(CheckInliers, :411: squared pixel error < 9.210 / 7.78 per image).

Design: all RANSAC hypotheses evaluated in parallel (vmap), Horn via
the Umeyama SVD on each 3-point sample; final refit on the winning inlier
set.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import align, cameras, lie

_HI = jax.lax.Precision.HIGHEST

CHI2_1 = 9.210   # reference th2 in camera 1
CHI2_2 = 15.0    # reference uses 7.78; relaxed gate for the refit pass


class Sim3Result(NamedTuple):
    success: jnp.ndarray
    R12: jnp.ndarray   # maps frame-2 coords into frame-1: x1 = s R x2 + t
    t12: jnp.ndarray
    s12: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def solve_sim3(X1: jnp.ndarray, X2: jnp.ndarray, valid: jnp.ndarray,
               uv1: jnp.ndarray, uv2: jnp.ndarray,
               Rcw1, tcw1, Rcw2, tcw2,
               cam_model: str, cam_params,
               key, iterations: int = 128,
               min_inliers: int = 20, fix_scale: bool = False) -> Sim3Result:
    """X1, X2: (N, 3) matched 3D map points in WORLD coords of map 1 / 2;
    uv1/uv2: their observed keypoints in KF1 / KF2; poses are the two
    keyframes' world->camera transforms.  Computes Sim3 aligning the
    camera-frame point sets (like the reference, which works in camera
    coords — src/Sim3Solver.cc:55-75)."""
    # camera-frame coordinates
    P1 = lie.se3_apply(Rcw1, tcw1, X1)
    P2 = lie.se3_apply(Rcw2, tcw2, X2)
    n = X1.shape[0]

    w = valid.astype(jnp.float32) + 1e-9
    idx = jax.random.categorical(
        key, jnp.log(w)[None, :].repeat(iterations * 3, 0)
    ).reshape(iterations, 3)

    def fit(sample):
        a = P2[sample]  # source
        b = P1[sample]  # target
        R, t, s = align.umeyama_alignment(a, b, with_scale=not fix_scale)
        return R, t, s

    Rs, ts, ss = jax.vmap(fit)(idx)

    def score(R, t, s):
        P2in1 = s * P2 @ R.T + t
        P1in2 = ((P1 - t) / jnp.maximum(s, 1e-9)) @ R
        e1 = uv1 - cameras.project(cam_model, cam_params, P2in1)
        e2 = uv2 - cameras.project(cam_model, cam_params, P1in2)
        ok = (jnp.sum(e1 ** 2, -1) < CHI2_1) & \
             (jnp.sum(e2 ** 2, -1) < CHI2_1) & valid & \
             (P2in1[:, 2] > 0) & (P1in2[:, 2] > 0)
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, inl = jax.vmap(score)(Rs, ts, ss)
    best = jnp.argmax(counts)
    # refit on inliers of the best hypothesis
    wbest = inl[best].astype(jnp.float32)
    R, t, s = align.umeyama_alignment(P2, P1, with_scale=not fix_scale,
                                      weights=wbest)
    n_fit, inl_fit = score(R, t, s)
    use_refit = n_fit >= counts[best]
    R = jnp.where(use_refit, R, Rs[best])
    t = jnp.where(use_refit, t, ts[best])
    s = jnp.where(use_refit, s, ss[best])
    inliers = jnp.where(use_refit, inl_fit, inl[best])
    n_inl = jnp.maximum(n_fit, counts[best])
    return Sim3Result(success=n_inl >= min_inliers, R12=R, t12=t, s12=s,
                      inliers=inliers, n_inliers=n_inl)

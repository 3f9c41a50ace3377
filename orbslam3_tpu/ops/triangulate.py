"""DLT triangulation and alignment utilities.

(reference: src/GeometricTools.cc GeometricTools::Triangulate — SVD of the
4x4 DLT system; evaluation/evaluate_ate_scale.py Horn alignment;
src/GeometricReferencer.cpp:119-166 Umeyama with scale.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def triangulate_dlt(ray1: jnp.ndarray, ray2: jnp.ndarray,
                    Tcw1_R: jnp.ndarray, Tcw1_t: jnp.ndarray,
                    Tcw2_R: jnp.ndarray, Tcw2_t: jnp.ndarray) -> jnp.ndarray:
    """Triangulate world points from two normalized camera rays.

    ray_i: (..., 3) bearing in camera i with z=1 (or any scale);
    Tcw_i: world->camera.  Returns world xyz (..., 3).

    Solves the standard DLT rows (x*P3 - P1), (y*P3 - P2) for both views.
    The reference runs one 4x4 SVD per point; batched tiny SVDs are an
    iterative (Jacobi) kernel, so the default path solves the
    INHOMOGENEOUS system A[:, :3] X = -A[:, 3] by closed-form 3x3 normal
    equations (pure einsums).  The homogeneous formulations only differ for
    points at infinity, which the callers' parallax gates
    (cosParallax < 0.9998) reject anyway; `triangulate_dlt_svd` keeps the
    exact null-space solve for reference/tests.
    """
    A = _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t)
    M = A[..., :, :3]
    b = -A[..., :, 3]
    H = jnp.einsum("...ij,...ik->...jk", M, M, precision=_HI)
    g = jnp.einsum("...ij,...i->...j", M, b, precision=_HI)
    # closed-form SPD 3x3 inverse (adjugate)
    a, b2, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b2 * f
    co02 = b2 * e - c * d
    co11 = a * f - c * c
    co12 = b2 * c - a * e
    co22 = a * d - b2 * b2
    det = a * co00 + b2 * co01 + c * co02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([co00, co01, co02], -1),
        jnp.stack([co01, co11, co12], -1),
        jnp.stack([co02, co12, co22], -1),
    ], -2)
    def solve(rhs):
        return jnp.einsum("...ij,...j->...i", adj, rhs,
                          precision=_HI) * inv_det[..., None]

    X = solve(g)
    # two steps of iterative refinement against the ORIGINAL 4x3 system
    # (the normal equations square the conditioning; residuals computed
    # through M recover the lost digits — each step contracts the error
    # by ~cond(H)*eps_f32)
    for _ in range(2):
        rA = b - jnp.einsum("...ij,...j->...i", M, X, precision=_HI)
        X = X + solve(jnp.einsum("...ij,...i->...j", M, rA, precision=_HI))
    # degenerate systems (det ~ 0: rays parallel / point at infinity)
    # produce huge coordinates; callers' isfinite + reprojection gates
    # reject them, but keep them finite so downstream math stays clean
    return jnp.clip(X, -1e12, 1e12)


def _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t):
    P1 = jnp.concatenate([Tcw1_R, Tcw1_t[..., None]], axis=-1)  # (..., 3, 4)
    P2 = jnp.concatenate([Tcw2_R, Tcw2_t[..., None]], axis=-1)

    def rows(ray, P):
        x = ray[..., 0] / ray[..., 2]
        y = ray[..., 1] / ray[..., 2]
        r0 = x[..., None] * P[..., 2, :] - P[..., 0, :]
        r1 = y[..., None] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(ray1, P1)
    a2, a3 = rows(ray2, P2)
    return jnp.stack([a0, a1, a2, a3], axis=-2)  # (..., 4, 4)


def triangulate_dlt_svd(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t):
    """Exact homogeneous DLT via 4x4 SVD (reference
    GeometricTools::Triangulate) — an iterative batched SVD; kept as
    the oracle for tests and far-point edge cases."""
    A = _dlt_rows(ray1, ray2, Tcw1_R, Tcw1_t, Tcw2_R, Tcw2_t)
    _, _, Vt = jnp.linalg.svd(A)
    X = Vt[..., 3, :]
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]

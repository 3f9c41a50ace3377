"""Pose-only optimization (motion-only BA).

Parity target: Optimizer::PoseOptimization (reference src/Optimizer.cc:765-
1067): single SE3 vertex, unary reprojection edges with Huber sqrt(5.991),
4 rounds x 10 iterations; after each round edges are re-classified by chi2
(5.991 mono) and the robust kernel is dropped from round 3 (it==2 sets
setRobustKernel(0) for the remaining rounds).

Design: all edges evaluated batched; Gauss-Newton on the 6-dof pose
with a fixed iteration schedule (`lax.fori_loop`), inlier set carried as a
mask — no graph rebuild between rounds, just mask updates.  Pose is Tcw
(world->camera) with left-multiplicative update Exp(dx) * Tcw,
dx = [rho, phi].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, smallsolve
from . import robust

_HI = jax.lax.Precision.HIGHEST


class PoseOptResult(NamedTuple):
    R: jnp.ndarray        # (3,3) optimized R_cw
    t: jnp.ndarray        # (3,) optimized t_cw
    inliers: jnp.ndarray  # (N,) bool final inlier mask
    n_inliers: jnp.ndarray
    chi2: jnp.ndarray     # (N,) final per-edge chi2


def _reproj_residual_jac(cam_model, cam_params, R, t, X, uv):
    """Residual e = uv - proj(R X + t) and Jacobian de/d[rho, phi] (left-
    multiplicative) for all points: X (N,3), uv (N,2) -> (N,2), (N,2,6)."""
    Xc = lie.se3_apply(R, t, X)
    e = uv - cameras.project(cam_model, cam_params, Xc)
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)  # (N,2,3)
    # dXc/drho = I, dXc/dphi = -hat(Xc)
    dXc = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), (X.shape[0], 3, 3)), -lie.hat(Xc)],
        axis=-1)  # (N, 3, 6)
    J = -jnp.einsum("nij,njk->nik", Jproj, dXc, precision=_HI)
    return e, J, Xc


def pose_optimization(R0, t0, X, uv, inv_sigma2, valid,
                      cam_model: str, cam_params,
                      rounds: int = 4, its_per_round: int = 3,
                      chi2_th: float = robust.CHI2_MONO,
                      min_depth: float = 1e-2) -> PoseOptResult:
    """Optimize Tcw against fixed world points.

    X: (N,3) world points; uv: (N,2) observations; inv_sigma2: (N,) octave
    information; valid: (N,) bool.  Returns optimized pose + inliers.
    """
    delta_huber = chi2_th ** 0.5

    def gn_iters(R, t, mask, use_robust, n_its):
        def body(_, carry):
            R, t = carry
            e, J, Xc = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
            chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
            w = jnp.where(use_robust,
                          robust.huber_weight(chi2, delta_huber), 1.0)
            w = w * inv_sigma2 * mask
            # One Gram contraction for the whole normal system: with
            # G = [J | e]^T W [J | e] (7x7), H = G[:6,:6] and
            # b = +J^T W e = -G[:6,6] sign-adjusted below  (e is obs -
            # pred; GN solves H dx = -J^T W r with r = -e)
            Je = jnp.concatenate([J, e[..., None]], axis=-1)  # (N, 2, 7)
            G = jnp.einsum("nik,n,nil->kl", Je, w, Je, precision=_HI)
            H = G[:6, :6] + jnp.eye(6) * 1e-6
            b = -G[:6, 6]
            # unrolled Cholesky keeps the whole GN iteration fusable
            # (jnp.linalg.solve would add LU-kernel latency x40 iterations)
            dx = smallsolve.solve_psd(H, b)
            dR, dt = lie.se3_exp(dx)
            R2, t2 = lie.se3_compose(dR, dt, R, t)
            return lie.normalize_rotation(R2), t2

        return jax.lax.fori_loop(0, n_its, body, (R, t))

    R, t = R0, t0
    mask = valid.astype(jnp.float32)
    for rnd in range(rounds):
        use_robust = rnd < 2  # reference drops the kernel from round 3
        R, t = gn_iters(R, t, mask, use_robust, its_per_round)
        e, _, Xc = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        depth_ok = Xc[..., 2] > min_depth
        mask = (valid & (chi2 <= chi2_th) & depth_ok).astype(jnp.float32)

    e, _, _ = _reproj_residual_jac(cam_model, cam_params, R, t, X, uv)
    chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
    inl = mask > 0
    return PoseOptResult(R=R, t=t, inliers=inl,
                         n_inliers=jnp.sum(inl.astype(jnp.int32)), chi2=chi2)

"""Visual-inertial pose optimization of a single frame.

Parity target: Optimizer::PoseInertialOptimizationLastKeyFrame
(reference src/Optimizer.cc:3447-3845): optimize the current frame's
15-dof state [pose, velocity, biases] against
  * unary monocular reprojection edges (EdgeMonoOnlyPose, Huber
    sqrt(5.991), 4 rounds with chi2 re-classification),
  * the inertial edge to the last keyframe (EdgeInertial; KF state fixed),
  * gyro/acc bias random-walk edges to the KF biases;
the reference finishes by Schur-marginalizing a 30x30 Hessian into a
15-dof prior (ConstraintPoseImu) carried to the next frame — here the
returned Hessian plays that role when the caller requests it.

Design: one GN program, fixed 4x5 masked rounds; Jacobians of the
visual part analytic, of the inertial part via jacfwd on the 15-dof
local update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, smallsolve
from . import robust
from .inertial import PreintFactor, inertial_residual, info_from_cov
from .vi_ba import STATE_DIM, apply_delta

_HI = jax.lax.Precision.HIGHEST


class VIPoseResult(NamedTuple):
    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    H: jnp.ndarray  # (15,15) final Gauss-Newton Hessian (frame prior)


def vi_pose_optimization(Rwb0, pwb0, vel0, bias0,
                         Rwb_kf, pwb_kf, vel_kf, bias_kf,
                         factor: PreintFactor,
                         X, uv, inv_sigma2, valid,
                         cam_model: str, cam_params,
                         Rcb, tcb, gravity,
                         rounds: int = 4, its_per_round: int = 5,
                         chi2_th: float = robust.CHI2_MONO) -> VIPoseResult:
    """Optimize the current frame's body state; the last KF is fixed.

    `factor` holds ONE preintegration (capacity-1 PreintFactor) from the
    KF to this frame.  X/uv: matched map points & observations.
    """
    delta_h = chi2_th ** 0.5
    W9 = info_from_cov(factor.C[0, :9, :9])
    L9 = jnp.linalg.cholesky(W9 + jnp.eye(9) * 1e-12)
    Wb = jnp.linalg.inv(factor.C[0, 9:15, 9:15] + jnp.eye(6) * 1e-12)
    Lb = jnp.linalg.cholesky(Wb)

    def visual_terms(Rwb, pwb, mask, use_robust):
        Rbw = Rwb.T
        Xb = jnp.matmul(X - pwb, Rbw.T, precision=_HI)
        Xc = jnp.matmul(Xb, Rcb.T, precision=_HI) + tcb
        e = uv - cameras.project(cam_model, cam_params, Xc)
        Jproj = cameras.project_jac(cam_model, cam_params, Xc)
        # dXc/d[dtheta, dp]: Rwb' = Rwb Exp(dth) => Xb' = Exp(-dth) Rbw (X-p)
        #   dXb/ddth = hat(Xb); dXb/dp = -Rbw
        n = X.shape[0]
        dXb = jnp.concatenate([lie.hat(Xb), -jnp.broadcast_to(Rbw, (n, 3, 3))],
                              axis=-1)  # (n,3,6)
        J = -jnp.einsum("nij,jk,nkl->nil", Jproj,
                        Rcb, dXb, precision=_HI)  # (n,2,6)
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        w_rob = jnp.where(use_robust, robust.huber_weight(chi2, delta_h), 1.0)
        w = inv_sigma2 * w_rob * mask * (Xc[:, 2] > 1e-2).astype(jnp.float32)
        return e, J, w, chi2, Xc

    def inertial_terms(Rwb, pwb, vel, bias):
        def res(d):
            R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, d)
            r9 = inertial_residual(factor, 0, Rwb_kf, pwb_kf, vel_kf,
                                   R2, p2, v2, bias_kf, gravity)
            rb = (b2 - bias_kf)
            return jnp.concatenate([
                jnp.matmul(L9.T, r9, precision=_HI),
                jnp.matmul(Lb.T, rb, precision=_HI)])

        z = jnp.zeros(STATE_DIM)
        r = res(z)
        J = jax.jacfwd(res)(z)
        return r, J

    def gn(Rwb, pwb, vel, bias, mask, use_robust, n_its):
        def body(_, carry):
            Rwb, pwb, vel, bias = carry
            e, Jv, w, _, _ = visual_terms(Rwb, pwb, mask, use_robust)
            H = jnp.zeros((STATE_DIM, STATE_DIM))
            b = jnp.zeros(STATE_DIM)
            Hv = jnp.einsum("nik,n,nil->kl", Jv, w, Jv, precision=_HI)
            bv = -jnp.einsum("nik,n,ni->k", Jv, w, e, precision=_HI)
            H = H.at[:6, :6].add(Hv)
            b = b.at[:6].add(bv)
            r_in, J_in = inertial_terms(Rwb, pwb, vel, bias)
            H = H + jnp.matmul(J_in.T, J_in, precision=_HI)
            b = b - jnp.matmul(J_in.T, r_in, precision=_HI)
            H = H + jnp.eye(STATE_DIM) * 1e-6
            dx = smallsolve.solve_psd(H, b)
            R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, dx)
            return lie.normalize_rotation(R2), p2, v2, b2

        return jax.lax.fori_loop(0, n_its, body, (Rwb, pwb, vel, bias))

    Rwb, pwb, vel, bias = Rwb0, pwb0, vel0, bias0
    mask = valid.astype(jnp.float32)
    for rnd in range(rounds):
        use_robust = jnp.asarray(rnd < 2)
        Rwb, pwb, vel, bias = gn(Rwb, pwb, vel, bias, mask, use_robust,
                                 its_per_round)
        e, _, _, chi2, Xc = visual_terms(Rwb, pwb, mask, use_robust)
        mask = (valid & (chi2 <= chi2_th) & (Xc[:, 2] > 1e-2)).astype(
            jnp.float32)

    e, Jv, w, chi2, _ = visual_terms(Rwb, pwb, mask, jnp.asarray(False))
    H = jnp.zeros((STATE_DIM, STATE_DIM)).at[:6, :6].add(
        jnp.einsum("nik,n,nil->kl", Jv, w, Jv, precision=_HI))
    r_in, J_in = inertial_terms(Rwb, pwb, vel, bias)
    H = H + jnp.matmul(J_in.T, J_in, precision=_HI)
    inl = mask > 0
    return VIPoseResult(Rwb=Rwb, pwb=pwb, vel=vel, bias=bias,
                        inliers=inl,
                        n_inliers=jnp.sum(inl.astype(jnp.int32)), H=H)


class VIPosePrior(NamedTuple):
    """Marginalized 15-dof frame prior (reference ConstraintPoseImu,
    include/G2oTypes.h:705, carried as Frame::mpcpi)."""
    Rwb: jnp.ndarray   # linearization state
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray
    H: jnp.ndarray     # (15,15) information


def _state_diff(Rwb, pwb, vel, bias, prior: VIPosePrior):
    """15-dof local difference est (-) prior, matching apply_delta's
    right-mult rotation / additive parametrization (EdgePriorPoseImu
    residual, reference G2oTypes.h:731)."""
    return jnp.concatenate([
        lie.log_so3(jnp.matmul(prior.Rwb.T, Rwb, precision=_HI)),
        pwb - prior.pwb, vel - prior.vel, bias - prior.bias])


def vi_pose_optimization_last_frame(
        Rwb0, pwb0, vel0, bias0,          # current-frame initial state
        prior: VIPosePrior,               # previous frame's carried prior
        factor: PreintFactor,             # preintegration prev -> cur
        X, uv, inv_sigma2, valid,
        cam_model: str, cam_params,
        Rcb, tcb, gravity,
        rounds: int = 4, its_per_round: int = 5,
        chi2_th: float = robust.CHI2_MONO):
    """PoseInertialOptimizationLastFrame parity (reference
    src/Optimizer.cc:3846-4276): jointly optimize [prev(15), cur(15)]
    where prev is constrained by its marginalized prior
    (EdgePriorPoseImu) and the two frames by the preintegration +
    bias-random-walk edges; visual unary edges act on cur.  Ends by
    Schur-marginalizing prev out of the 30x30 Hessian (reference
    Marginalize, :2882-2963) to produce the NEXT frame's prior.

    Returns (VIPoseResult for cur, new VIPosePrior for cur).
    """
    delta_h = chi2_th ** 0.5
    D = 2 * STATE_DIM
    W9 = info_from_cov(factor.C[0, :9, :9])
    L9 = jnp.linalg.cholesky(W9 + jnp.eye(9) * 1e-12)
    Wb = jnp.linalg.inv(factor.C[0, 9:15, 9:15] + jnp.eye(6) * 1e-12)
    Lb = jnp.linalg.cholesky(Wb)
    Hp = 0.5 * (prior.H + prior.H.T) + jnp.eye(STATE_DIM) * 1e-6
    Lp = jnp.linalg.cholesky(Hp)

    def visual_terms(Rwb, pwb, mask, use_robust):
        Rbw = Rwb.T
        Xb = jnp.matmul(X - pwb, Rbw.T, precision=_HI)
        Xc = jnp.matmul(Xb, Rcb.T, precision=_HI) + tcb
        e = uv - cameras.project(cam_model, cam_params, Xc)
        Jproj = cameras.project_jac(cam_model, cam_params, Xc)
        n = X.shape[0]
        dXb = jnp.concatenate([lie.hat(Xb),
                               -jnp.broadcast_to(Rbw, (n, 3, 3))], axis=-1)
        J = -jnp.einsum("nij,jk,nkl->nil", Jproj, Rcb, dXb, precision=_HI)
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        w_rob = jnp.where(use_robust, robust.huber_weight(chi2, delta_h), 1.0)
        w = inv_sigma2 * w_rob * mask * (Xc[:, 2] > 1e-2).astype(jnp.float32)
        return e, J, w, chi2, Xc

    def chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc):
        """Whitened [inertial(9), biasRW(6), prior(15)] residuals +
        Jacobian over the 30-dof joint delta."""
        def res(d):
            R1, p1, v1, b1 = apply_delta(Rp, pp, vp, bp, d[:STATE_DIM])
            R2, p2, v2, b2 = apply_delta(Rc, pc, vc, bc, d[STATE_DIM:])
            r9 = inertial_residual(factor, 0, R1, p1, v1, R2, p2, v2,
                                   b1, gravity)
            rb = b2 - b1
            rp = _state_diff(R1, p1, v1, b1, prior)
            return jnp.concatenate([
                jnp.matmul(L9.T, r9, precision=_HI),
                jnp.matmul(Lb.T, rb, precision=_HI),
                jnp.matmul(Lp.T, rp, precision=_HI)])

        z = jnp.zeros(D)
        return res(z), jax.jacfwd(res)(z)

    def gn(state, mask, use_robust, n_its):
        def body(_, s):
            Rp, pp, vp, bp, Rc, pc, vc, bc = s
            e, Jv, w, _, _ = visual_terms(Rc, pc, mask, use_robust)
            H = jnp.zeros((D, D))
            b = jnp.zeros(D)
            Hv = jnp.einsum("nik,n,nil->kl", Jv, w, Jv, precision=_HI)
            bv = -jnp.einsum("nik,n,ni->k", Jv, w, e, precision=_HI)
            H = H.at[STATE_DIM:STATE_DIM + 6,
                     STATE_DIM:STATE_DIM + 6].add(Hv)
            b = b.at[STATE_DIM:STATE_DIM + 6].add(bv)
            r_ch, J_ch = chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc)
            H = H + jnp.matmul(J_ch.T, J_ch, precision=_HI)
            b = b - jnp.matmul(J_ch.T, r_ch, precision=_HI)
            H = H + jnp.eye(D) * 1e-6
            dx = smallsolve.solve_psd_blocked(H, b, bs=6)
            R1, p1, v1, b1 = apply_delta(Rp, pp, vp, bp, dx[:STATE_DIM])
            R2, p2, v2, b2 = apply_delta(Rc, pc, vc, bc, dx[STATE_DIM:])
            return (lie.normalize_rotation(R1), p1, v1, b1,
                    lie.normalize_rotation(R2), p2, v2, b2)

        return jax.lax.fori_loop(0, n_its, body, state)

    state = (prior.Rwb, prior.pwb, prior.vel, prior.bias,
             Rwb0, pwb0, vel0, bias0)
    mask = valid.astype(jnp.float32)
    for rnd in range(rounds):
        use_robust = jnp.asarray(rnd < 2)
        state = gn(state, mask, use_robust, its_per_round)
        Rc, pc = state[4], state[5]
        e, _, _, chi2, Xc = visual_terms(Rc, pc, mask, use_robust)
        mask = (valid & (chi2 <= chi2_th) & (Xc[:, 2] > 1e-2)).astype(
            jnp.float32)

    Rp, pp, vp, bp, Rc, pc, vc, bc = state
    # final 30x30 Hessian at convergence, then Schur-marginalize prev
    e, Jv, w, chi2, _ = visual_terms(Rc, pc, mask, jnp.asarray(False))
    H = jnp.zeros((D, D))
    H = H.at[STATE_DIM:STATE_DIM + 6, STATE_DIM:STATE_DIM + 6].add(
        jnp.einsum("nik,n,nil->kl", Jv, w, Jv, precision=_HI))
    _, J_ch = chain_terms(Rp, pp, vp, bp, Rc, pc, vc, bc)
    H = H + jnp.matmul(J_ch.T, J_ch, precision=_HI)
    Hpp = H[:STATE_DIM, :STATE_DIM] + jnp.eye(STATE_DIM) * 1e-6
    Hpc = H[:STATE_DIM, STATE_DIM:]
    Hcc = H[STATE_DIM:, STATE_DIM:]
    H_marg = Hcc - jnp.matmul(Hpc.T, jnp.linalg.solve(Hpp, Hpc),
                              precision=_HI)
    inl = mask > 0
    res = VIPoseResult(Rwb=Rc, pwb=pc, vel=vc, bias=bc, inliers=inl,
                       n_inliers=jnp.sum(inl.astype(jnp.int32)), H=H_marg)
    new_prior = VIPosePrior(Rwb=Rc, pwb=pc, vel=vc, bias=bc,
                            H=0.5 * (H_marg + H_marg.T))
    return res, new_prior

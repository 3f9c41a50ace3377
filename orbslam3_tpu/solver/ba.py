"""Visual bundle adjustment: batched Levenberg-Marquardt with Schur
complement on the camera-point system.

Parity targets (reference src/Optimizer.cc):
  * BundleAdjustment / GlobalBundleAdjustemnt (:60-369) — full-map visual
    BA, marginalized points, Huber sqrt(5.991) mono, LM;
  * LocalBundleAdjustment (:1069-1360) — window of cameras, fixed boundary
    cameras, 10 iterations.

Design (SURVEY §7.1): observations are a fixed-capacity COO list
(cam_idx, pt_idx, uv, inv_sigma2, valid).  Per LM iteration:
  1. residuals/Jacobians for all observations in one batch;
  2. point blocks H_pp (3x3) inverted in closed form;
  3. the reduced camera system S = H_cc - C H_pp^-1 C^T is NEVER
     materialized: the camera-point coupling stays as per-observation
     (6,3) blocks and S is applied matrix-free (gather -> 6x3 block ops
     -> segment-sum), so memory/compute are O(observations) instead of
     O(K^2 P) — this is what lets full-map GBA/FIBA run at capacity and
     what the distributed backend shards (every reduction is a psum);
  4. preconditioned CG on the reduced system with the EXACT block-Jacobi
     preconditioner (the S diagonal is a per-observation segment-sum);
     LM's accept/reject makes the inexact solve safe (inexact LM);
  5. point back-substitution, batched.
Fixed cameras are handled by zeroing their Jacobians (their blocks stay
identity).  LM acceptance is branch-free (jnp.where on the carried state).

This module is the single-device core; orbslam3_tpu/parallel runs the
same assembly under shard_map (points+observations partitioned,
`reduce=psum` on every K-sized contraction).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, smallsolve
from . import robust

_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Fixed-capacity visual BA problem (COO observations).

    Stereo observations carry obs_ur >= 0 (rectified right-image u); with
    a nonzero `stereo_bf` (fx * baseline) passed to bundle_adjust they add
    the reference's third residual row  r3 = ur - (u_proj - bf / z)
    (EdgeStereoSE3ProjectXYZ, reference include/OptimizableTypes.h)."""
    # cameras
    R: jnp.ndarray           # (K, 3, 3) R_cw
    t: jnp.ndarray           # (K, 3)
    cam_fixed: jnp.ndarray   # (K,) bool — pose held constant
    cam_valid: jnp.ndarray   # (K,) bool
    # points
    X: jnp.ndarray           # (P, 3)
    pt_valid: jnp.ndarray    # (P,) bool
    # observations
    obs_cam: jnp.ndarray     # (O,) int32
    obs_pt: jnp.ndarray      # (O,) int32
    obs_uv: jnp.ndarray      # (O, 2)
    obs_inv_sigma2: jnp.ndarray  # (O,)
    obs_valid: jnp.ndarray   # (O,) bool
    obs_ur: jnp.ndarray = None   # (O,) stereo right-u; -1/None = mono
    # optional per-camera position priors (GNSS-constrained BA — the
    # fork's LocalGNSSBundleAdjustment edges, reference
    # src/Optimizer.cc:1362-1604, realized as unary camera-center priors)
    prior_pos: jnp.ndarray = None  # (K,3) prior camera center (world)
    prior_w: jnp.ndarray = None    # (K,) information 1/sigma^2; 0 = none


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    X: jnp.ndarray
    obs_chi2: jnp.ndarray    # (O,) final chi2 per observation
    cost: jnp.ndarray        # robust total cost


def _residuals(prob: BAProblem, R, t, X, cam_model, cam_params,
               stereo_bf: float = 0.0):
    ci, pi = prob.obs_cam, prob.obs_pt
    Xc = lie.se3_apply(R[ci], t[ci], X[pi])
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.obs_uv - uvp
    if stereo_bf > 0.0 and prob.obs_ur is not None:
        ur_pred = uvp[:, 0] - stereo_bf / jnp.maximum(Xc[:, 2], 1e-6)
        has_d = prob.obs_ur >= 0
        e3 = jnp.where(has_d, prob.obs_ur - ur_pred, 0.0)
        e = jnp.concatenate([e, e3[:, None]], axis=1)
    return e, Xc


def _jacobians(prob: BAProblem, R, t, X, cam_model, cam_params,
               stereo_bf: float = 0.0):
    """Per-observation residual + Jacobians wrt camera (left-mult se3) and
    point (world).  Returns e (O,r), Jc (O,r,6), Jp (O,r,3), Xc with
    r = 2 (mono) or 3 (stereo row appended)."""
    ci, pi = prob.obs_cam, prob.obs_pt
    Xc = lie.se3_apply(R[ci], t[ci], X[pi])
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.obs_uv - uvp
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)   # (O,2,3)
    O = ci.shape[0]
    if stereo_bf > 0.0 and prob.obs_ur is not None:
        z = jnp.maximum(Xc[:, 2], 1e-6)
        ur_pred = uvp[:, 0] - stereo_bf / z
        has_d = prob.obs_ur >= 0
        e3 = jnp.where(has_d, prob.obs_ur - ur_pred, 0.0)
        e = jnp.concatenate([e, e3[:, None]], axis=1)
        # d ur_pred/dXc = d u/dXc + bf/z^2 * dz/dXc
        Jur = Jproj[:, 0, :] + (stereo_bf / (z * z))[:, None] *             jnp.concatenate([jnp.zeros((O, 2)), jnp.ones((O, 1))], axis=1)
        Jur = Jur * has_d[:, None].astype(jnp.float32)
        Jproj = jnp.concatenate([Jproj, Jur[:, None, :]], axis=1)  # (O,3,3)
    dXc_dcam = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), (O, 3, 3)), -lie.hat(Xc)], axis=-1)
    Jc = -jnp.einsum("nij,njk->nik", Jproj, dXc_dcam, precision=_HI)
    Jp = -jnp.einsum("nij,njk->nik", Jproj, R[ci], precision=_HI)
    return e, Jc, Jp, Xc


def _spd_inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form inverse of SPD 3x3 blocks via adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([co00, co01, co02], -1),
        jnp.stack([co01, co11, co12], -1),
        jnp.stack([co02, co12, co22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _build_normal_eq(prob: BAProblem, R, t, X, cam_model, cam_params,
                     chi2_th: float, use_robust: bool,
                     stereo_bf: float = 0.0):
    """Weighted residuals/Jacobians and the Schur pieces."""
    e, Jc, Jp, _ = _jacobians(prob, R, t, X, cam_model, cam_params,
                              stereo_bf)
    w_info = prob.obs_inv_sigma2
    chi2 = jnp.sum(e * e, axis=-1) * w_info
    w_rob = robust.huber_weight(chi2, chi2_th ** 0.5) if use_robust else 1.0
    m = prob.obs_valid & prob.pt_valid[prob.obs_pt] & prob.cam_valid[prob.obs_cam]
    w = w_info * w_rob * m.astype(jnp.float32)
    # zero out jacobians of fixed cameras
    free_cam = (~prob.cam_fixed)[prob.obs_cam].astype(jnp.float32)
    Jc = Jc * free_cam[:, None, None]

    K = prob.R.shape[0]
    P = prob.X.shape[0]
    wJc = Jc * w[:, None, None]
    # camera diag blocks and gradient
    Hcc = jnp.zeros((K, 6, 6)).at[prob.obs_cam].add(
        jnp.einsum("nik,nil->nkl", wJc, Jc, precision=_HI))
    bc = jnp.zeros((K, 6)).at[prob.obs_cam].add(
        -jnp.einsum("nik,ni->nk", wJc, e, precision=_HI))
    if prob.prior_pos is not None and prob.prior_w is not None:
        # camera-center prior r = O_k - prior; O = -R^T t, dO/ddt = -R^T
        # (left-mult update), dO/ddtheta = 0 to first order
        w_pr = prob.prior_w * (~prob.cam_fixed).astype(jnp.float32) * \
            prob.cam_valid.astype(jnp.float32)
        Ow = -jnp.einsum("kji,kj->ki", R, t, precision=_HI)
        r_pr = Ow - prob.prior_pos
        Hcc = Hcc.at[:, 3:6, 3:6].add(w_pr[:, None, None] * jnp.eye(3)[None])
        bc = bc.at[:, 3:6].add(
            w_pr[:, None] * jnp.einsum("kij,kj->ki", R, r_pr, precision=_HI))
    # point blocks and gradient
    wJp = Jp * w[:, None, None]
    Hpp = jnp.zeros((P, 3, 3)).at[prob.obs_pt].add(
        jnp.einsum("nik,nil->nkl", wJp, Jp, precision=_HI))
    bp = jnp.zeros((P, 3)).at[prob.obs_pt].add(
        -jnp.einsum("nik,ni->nk", wJp, e, precision=_HI))
    # camera-point coupling kept PER OBSERVATION: Cobs[n] = J_c^T W J_p
    # (6,3) — the sparse C is applied via gathers/segment-sums, never
    # densified to (K,P,6,3)
    Cobs = jnp.einsum("nik,nil->nkl", wJc, Jp, precision=_HI)
    cost = jnp.sum(jnp.where(use_robust,
                             _huber_cost(chi2, chi2_th ** 0.5), chi2) *
                   m.astype(jnp.float32))
    return Hcc, bc, Hpp, bp, Cobs, cost, chi2, m


def _huber_cost(chi2, delta):
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(e <= delta, chi2, 2 * delta * e - delta * delta)


def _cost_only(prob: BAProblem, R, t, X, cam_model, cam_params,
               chi2_th: float, use_robust: bool, stereo_bf: float = 0.0):
    e, _ = _residuals(prob, R, t, X, cam_model, cam_params, stereo_bf)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    m = (prob.obs_valid & prob.pt_valid[prob.obs_pt] &
         prob.cam_valid[prob.obs_cam]).astype(jnp.float32)
    c = _huber_cost(chi2, chi2_th ** 0.5) if use_robust else chi2
    total = jnp.sum(c * m)
    if prob.prior_pos is not None and prob.prior_w is not None:
        w_pr = prob.prior_w * (~prob.cam_fixed).astype(jnp.float32) * \
            prob.cam_valid.astype(jnp.float32)
        Ow = -jnp.einsum("kji,kj->ki", R, t, precision=_HI)
        total = total + jnp.sum(w_pr * jnp.sum(
            (Ow - prob.prior_pos) ** 2, axis=-1))
    return total


def _identity_reduce(x):
    return x


def _solve_schur(Hcc, bc, Hpp, bp, Cobs, obs_cam, obs_pt, lam,
                 cam_fixed, pt_valid, pcg_iters: int = 32,
                 reduce=_identity_reduce):
    """One LM step, matrix-free: returns (dx_cam (K,6), dx_pt (P,3)).

    The reduced camera system S x = rhs is solved by PCG with the exact
    block-Jacobi preconditioner; S is applied through the per-observation
    coupling blocks (gather -> 6x3 ops -> segment-sum).  `reduce` wraps
    every K-sized contraction (identity single-device; lax.psum under
    shard_map when points/observations are sharded — Hcc/bc must then be
    passed in already-reduced form and Cobs/bp/Hpp shard-local).
    """
    P = Hpp.shape[0]
    K = Hcc.shape[0]
    # additive LM damping on both blocks (g2o: H + lambda I)
    Hcc_d = Hcc + lam * jnp.eye(6)[None]
    Hpp_d = Hpp + lam * jnp.eye(3)[None]
    # guard empty points/cameras: make their blocks identity
    pt_on = pt_valid.astype(jnp.float32)[:, None, None]
    Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
    Hpp_inv = _spd_inv3(Hpp_d)

    free = (~cam_fixed).astype(jnp.float32)

    # W_n = Cobs_n Hpp_inv[pt_n]  (6,3) per observation
    CW = jnp.einsum("nij,njl->nil", Cobs, Hpp_inv[obs_pt], precision=_HI)

    def S_matvec(x):
        """(K,6) -> (K,6): Hcc_d x - C Hpp_inv C^T x, fixed cams identity."""
        xm = x * free[:, None]
        u = jnp.einsum("nij,ni->nj", Cobs, xm[obs_cam], precision=_HI)
        s = jnp.zeros((P, 3)).at[obs_pt].add(u)
        v = jnp.einsum("nil,nl->ni", CW, s[obs_pt], precision=_HI)
        y = jnp.einsum("kij,kj->ki", Hcc_d, xm, precision=_HI)
        y = y - reduce(jnp.zeros((K, 6)).at[obs_cam].add(v))
        return y * free[:, None] + x * (1 - free)[:, None]

    # rhs = bc - C Hpp_inv bp
    rv = jnp.einsum("nil,nl->ni", CW, bp[obs_pt], precision=_HI)
    rhs = (bc - reduce(jnp.zeros((K, 6)).at[obs_cam].add(rv))) * \
        free[:, None]

    # exact block-diagonal of S: D_k = Hcc_d[k] - sum_{n:cam=k} CW_n C_n^T
    Dn = jnp.einsum("nil,nml->nim", CW, Cobs, precision=_HI)
    D = Hcc_d - reduce(jnp.zeros((K, 6, 6)).at[obs_cam].add(Dn))
    D = D * free[:, None, None] + jnp.eye(6)[None] * (1 - free)[:, None, None]
    D = D + jnp.eye(6)[None] * 1e-8
    D_inv = jnp.linalg.inv(D)

    def precond(r):
        return jnp.einsum("kij,kj->ki", D_inv, r, precision=_HI)

    # PCG (fixed iteration count — branch-free, inexact-LM safe)
    x0 = jnp.zeros((K, 6))
    r0 = rhs
    z0 = precond(r0)
    p0 = z0

    def pcg_step(carry, _):
        x, r, z, p = carry
        Ap = S_matvec(p)
        rz = jnp.sum(r * z)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        beta = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        p2 = z2 + beta * p
        return (x2, r2, z2, p2), None

    (dx_cam, _, _, _), _ = jax.lax.scan(
        pcg_step, (x0, r0, z0, p0), None, length=pcg_iters)
    dx_cam = dx_cam * free[:, None]

    # back-substitute points: dx_p = Hpp_inv (bp - C^T dx_cam)
    u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[obs_cam], precision=_HI)
    s = jnp.zeros((P, 3)).at[obs_pt].add(u)
    dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - s, precision=_HI)
    dx_pt = dx_pt * pt_valid.astype(jnp.float32)[:, None]
    return dx_cam, dx_pt


def _chol3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form Cholesky of SPD 3x3 blocks (lower L, A=LL^T)."""
    eps = 1e-12
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = jnp.sqrt(jnp.maximum(a11, eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(jnp.maximum(a22 - l21 * l21, eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a33 - l31 * l31 - l32 * l32, eps))
    z = jnp.zeros_like(l11)
    return jnp.stack([jnp.stack([l11, z, z], -1),
                      jnp.stack([l21, l22, z], -1),
                      jnp.stack([l31, l32, l33], -1)], -2)


def _solve_schur_dense(Hcc, bc, Hpp, bp, Cobs, obs_cam, obs_pt, lam,
                       cam_fixed, pt_valid):
    """One LM step via the EXPLICIT (6K, 6K) Schur complement.

    For window-sized problems (K <= ~32) the reduced camera system is
    tiny; a direct solve replaces the PCG iteration chain, whose dozens
    of small dependent kernels are pure device latency (the 10x32 LM/PCG
    schedule made local BA the dominant cost of a keyframe frame).  S is assembled without the (K, P, 6, 3) coupling
    tensor: with L_p = chol(Hpp_inv_p), the scatter
    G[cam_n, pt_n] += Cobs_n L_{pt_n} gives  sum_p C Hppinv C^T = G G^T
    as ONE (6K, 3P) @ (3P, 6K) matmul.
    """
    P = Hpp.shape[0]
    K = Hcc.shape[0]
    Hcc_d = Hcc + lam * jnp.eye(6)[None]
    Hpp_d = Hpp + lam * jnp.eye(3)[None]
    pt_on = pt_valid.astype(jnp.float32)[:, None, None]
    Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
    Hpp_inv = _spd_inv3(Hpp_d)
    L = _chol3(Hpp_inv)
    free = (~cam_fixed).astype(jnp.float32)

    U = jnp.einsum("nij,njl->nil", Cobs, L[obs_pt], precision=_HI)
    G = jnp.zeros((K, P, 6, 3)).at[obs_cam, obs_pt].add(U)
    Gr = G.transpose(0, 2, 1, 3).reshape(K * 6, P * 3)
    S_off = jnp.dot(Gr, Gr.T, precision=_HI).reshape(K, 6, K, 6)

    CW = jnp.einsum("nij,njl->nil", Cobs, Hpp_inv[obs_pt], precision=_HI)
    rv = jnp.einsum("nil,nl->ni", CW, bp[obs_pt], precision=_HI)
    rhs = (bc - jnp.zeros((K, 6)).at[obs_cam].add(rv)) * free[:, None]

    S = jnp.zeros((K, 6, K, 6))
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hcc_d)
    S = S - S_off
    # fixed cameras: identity rows/cols, zero rhs
    ff = free[:, None, None, None] * free[None, None, :, None]
    S = S * ff
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(
        jnp.eye(6)[None] * (1 - free)[:, None, None])
    # blocked unrolled Cholesky: jnp.linalg.solve's LU custom call has a
    # fixed kernel latency on every LM step
    dx_cam = smallsolve.solve_psd_blocked(
        S.reshape(K * 6, K * 6), rhs.reshape(K * 6), bs=6).reshape(K, 6)
    dx_cam = dx_cam * free[:, None]

    # back-substitute points: dx_p = Hpp_inv (bp - C^T dx_cam)
    u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[obs_cam], precision=_HI)
    s = jnp.zeros((P, 3)).at[obs_pt].add(u)
    dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - s, precision=_HI)
    dx_pt = dx_pt * pt_valid.astype(jnp.float32)[:, None]
    return dx_cam, dx_pt


def bundle_adjust(prob: BAProblem, cam_model: str, cam_params,
                  iterations: int = 10, lam0: float = 1e-5,
                  chi2_th: float = robust.CHI2_MONO,
                  use_robust: bool = True,
                  stereo_bf: float = 0.0,
                  pcg_iters: int = 32,
                  schur_solver: str = "pcg") -> BAResult:
    """LM loop with branch-free accept/reject (reference uses g2o LM;
    iteration counts per call site: 20 init GBA, 10 local, 25 inertial)."""

    def step(carry, _):
        R, t, X, lam, cost = carry
        Hcc, bc, Hpp, bp, Cobs, cur_cost, _, _ = _build_normal_eq(
            prob, R, t, X, cam_model, cam_params, chi2_th, use_robust,
            stereo_bf)
        if schur_solver == "dense":
            dx_cam, dx_pt = _solve_schur_dense(
                Hcc, bc, Hpp, bp, Cobs, prob.obs_cam, prob.obs_pt, lam,
                prob.cam_fixed, prob.pt_valid)
        else:
            dx_cam, dx_pt = _solve_schur(Hcc, bc, Hpp, bp, Cobs,
                                         prob.obs_cam, prob.obs_pt, lam,
                                         prob.cam_fixed, prob.pt_valid,
                                         pcg_iters=pcg_iters)
        dR, dt = lie.se3_exp(dx_cam)
        R_new, t_new = lie.se3_compose(dR, dt, R, t)
        R_new = lie.normalize_rotation(R_new)
        X_new = X + dx_pt
        new_cost = _cost_only(prob, R_new, t_new, X_new, cam_model,
                              cam_params, chi2_th, use_robust, stereo_bf)
        accept = new_cost < cur_cost
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        X = jnp.where(accept, X_new, X)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (R, t, X, lam, jnp.minimum(new_cost, cur_cost)), None

    init = (prob.R, prob.t, prob.X, jnp.asarray(lam0, jnp.float32),
            jnp.asarray(jnp.inf, jnp.float32))
    (R, t, X, _, cost), _ = jax.lax.scan(step, init, None, length=iterations)

    e, _ = _residuals(prob, R, t, X, cam_model, cam_params)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    return BAResult(R=R, t=t, X=X, obs_chi2=chi2, cost=cost)

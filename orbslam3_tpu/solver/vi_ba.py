"""Visual-inertial bundle adjustment: 15-dof body states (pose, velocity,
bias) + marginalized points.

Parity targets (reference src/Optimizer.cc):
  * FullInertialBA (:371-762): all KFs with VertexPose/VertexVelocity/
    bias vertices, EdgeInertial between consecutive KFs, EdgeGyroRW /
    EdgeAccRW bias random-walk edges (information from preintegration
    covariance blocks 9-11/12-14), optional bias priors (init mode),
    mono reprojection edges (Huber sqrt(5.991)), lambda0 = 1e-5;
  * LocalInertialBA (:2448-2881): same residuals over a sliding temporal
    window (10 KFs + fixed boundary), 25 its, lambda0 = 1e0 — realized by
    passing window masks in `cam_fixed`.

Design: per-edge Jacobians by forward-mode AD around a zero local
update (right-multiplicative on rotation, additive elsewhere), batched
over edges; the reduced 15K x 15K camera system is applied MATRIX-FREE
(per-observation coupling blocks + per-factor pair blocks, segment-sums)
and solved by PCG with the exact block-Jacobi preconditioner, exactly as
in solver/ba.py — no (K,P) or (K,K) dense tensors, so full-map
FullInertialBA runs at capacity.

Body/camera convention: body pose (Rwb, pwb); camera extrinsic Tcb
(camera <- body) fixed; world point X projects via
  Xc = Rcb (Rwb^T (X - pwb)) + tcb.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie
from . import robust
from .ba import _spd_inv3
from .inertial import PreintFactor, inertial_residual, info_from_cov

_HI = jax.lax.Precision.HIGHEST
STATE_DIM = 15  # [dtheta(3), dp(3), dv(3), dbg(3), dba(3)]


class VIProblem(NamedTuple):
    # body states
    Rwb: jnp.ndarray        # (K,3,3)
    pwb: jnp.ndarray        # (K,3)
    vel: jnp.ndarray        # (K,3)
    bias: jnp.ndarray       # (K,6)
    cam_fixed: jnp.ndarray  # (K,) pose+vel+bias fixed
    cam_valid: jnp.ndarray  # (K,)
    # points
    X: jnp.ndarray          # (P,3)
    pt_valid: jnp.ndarray
    # reprojection observations
    obs_cam: jnp.ndarray
    obs_pt: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_inv_sigma2: jnp.ndarray
    obs_valid: jnp.ndarray
    # inertial factors between KFs
    factors: PreintFactor
    # gravity in world frame (3,)
    gravity: jnp.ndarray
    # extrinsics camera <- body
    Rcb: jnp.ndarray        # (3,3)
    tcb: jnp.ndarray        # (3,)


def apply_delta(Rwb, pwb, vel, bias, d):
    """Local 15-dof update (right-mult rotation, additive rest)."""
    R2 = jnp.matmul(Rwb, lie.exp_so3(d[..., 0:3]), precision=_HI)
    return R2, pwb + d[..., 3:6], vel + d[..., 6:9], bias + d[..., 9:15]


def project_body(prob: VIProblem, Rwb, pwb, X, cam_model, cam_params):
    Xb = jnp.einsum("...ji,...j->...i", Rwb, X - pwb, precision=_HI)
    Xc = jnp.einsum("ij,...j->...i", prob.Rcb, Xb, precision=_HI) + prob.tcb
    return cameras.project(cam_model, cam_params, Xc), Xc


class VIBAResult(NamedTuple):
    Rwb: jnp.ndarray
    pwb: jnp.ndarray
    vel: jnp.ndarray
    bias: jnp.ndarray
    X: jnp.ndarray
    cost: jnp.ndarray


def _reproj_residuals(prob: VIProblem, Rwb, pwb, X, cam_model,
                      cam_params, use_robust=True):
    """Residual-only reprojection terms (for cost evaluation — no
    Jacobians)."""
    ci, pi = prob.obs_cam, prob.obs_pt
    uvp, Xc = project_body(prob, Rwb[ci], pwb[ci], X[pi], cam_model,
                           cam_params)
    e = prob.obs_uv - uvp
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    m = prob.obs_valid & prob.pt_valid[pi] & prob.cam_valid[ci]
    m &= Xc[..., 2] > 1e-2
    return e, chi2, m


def _reproj_terms(prob: VIProblem, Rwb, pwb, X, cam_model, cam_params,
                  use_robust=True):
    """Per-observation residual + ANALYTIC Jacobians wrt the 6-dof pose
    part (right-mult rotation delta, additive position) and the point.

    Same math as solver/vi_pose_opt.visual_terms:
      Xb = Rwb^T (X - pwb);  Xc = Rcb Xb + tcb;  e = uv - proj(Xc)
      dXb/ddtheta = hat(Xb)   (Rwb' = Rwb Exp(dth))
      dXb/dpwb    = -Rwb^T
      dXb/dX      = +Rwb^T
    The per-observation forward-mode AD this replaces cost ~9 projection
    evaluations per observation per linearization — the bulk of the
    inertial window BA's device time.
    """
    ci, pi = prob.obs_cam, prob.obs_pt
    Rbw = jnp.swapaxes(Rwb[ci], -1, -2)                     # (O,3,3)
    Xb = jnp.einsum("nij,nj->ni", Rbw, X[pi] - pwb[ci], precision=_HI)
    Xc = jnp.einsum("ij,nj->ni", prob.Rcb, Xb, precision=_HI) + prob.tcb
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.obs_uv - uvp
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)  # (O,2,3)
    O = ci.shape[0]
    dXb = jnp.concatenate([lie.hat(Xb), -Rbw], axis=-1)     # (O,3,6)
    JR = jnp.einsum("nij,jk->nik", Jproj, prob.Rcb, precision=_HI)
    Jc = -jnp.einsum("nij,njk->nik", JR, dXb, precision=_HI)   # (O,2,6)
    Jp = -jnp.einsum("nij,njk->nik", JR, Rbw, precision=_HI)   # (O,2,3)
    w_info = prob.obs_inv_sigma2
    chi2 = jnp.sum(e * e, axis=-1) * w_info
    w_rob = robust.huber_weight(chi2, robust.HUBER_MONO) if use_robust else 1.0
    m = prob.obs_valid & prob.pt_valid[pi] & prob.cam_valid[ci]
    # depth gate: negative-depth observations get zero weight
    m &= Xc[..., 2] > 1e-2
    w = w_info * w_rob * m.astype(jnp.float32)
    free = (~prob.cam_fixed)[ci].astype(jnp.float32)
    Jc = Jc * free[:, None, None]
    return e, Jc, Jp, w, chi2, m


def _inertial_residuals(prob: VIProblem, Rwb, pwb, vel, bias):
    """Residual-only inertial + bias-RW terms (cost evaluation — no
    per-factor jacfwd)."""
    f = prob.factors
    F = f.kf_i.shape[0]
    r = jax.vmap(lambda k: inertial_residual(
        f, k, Rwb[f.kf_i[k]], pwb[f.kf_i[k]], vel[f.kf_i[k]],
        Rwb[f.kf_j[k]], pwb[f.kf_j[k]], vel[f.kf_j[k]],
        bias[f.kf_i[k]], prob.gravity))(jnp.arange(F))
    W = jax.vmap(info_from_cov)(f.C[:, :9, :9])
    w_edge = f.valid.astype(jnp.float32) * \
        (~prob.cam_fixed[f.kf_i] | ~prob.cam_fixed[f.kf_j]).astype(
            jnp.float32)
    rb = bias[f.kf_j] - bias[f.kf_i]
    Wb = jnp.linalg.inv(f.C[:, 9:15, 9:15] + jnp.eye(6)[None] * 1e-12)
    return r, W, w_edge, rb, Wb


def _inertial_terms(prob: VIProblem, Rwb, pwb, vel, bias):
    """Per-factor 9-dof inertial residual + Jacobians wrt both 15-dof
    states, plus 6-dof bias-RW residual/info."""
    f = prob.factors
    F = f.kf_i.shape[0]

    def res_one(k, di, dj):
        i, j = f.kf_i[k], f.kf_j[k]
        Ri, pi_, vi, bi = apply_delta(Rwb[i], pwb[i], vel[i], bias[i], di)
        Rj, pj, vj, _ = apply_delta(Rwb[j], pwb[j], vel[j], bias[j], dj)
        return inertial_residual(f, k, Ri, pi_, vi, Rj, pj, vj, bi,
                                 prob.gravity)

    z = jnp.zeros(STATE_DIM)
    ks = jnp.arange(F)
    r = jax.vmap(lambda k: res_one(k, z, z))(ks)                      # (F,9)
    Ji = jax.vmap(lambda k: jax.jacfwd(
        lambda d: res_one(k, d, z))(z))(ks)                           # (F,9,15)
    Jj = jax.vmap(lambda k: jax.jacfwd(
        lambda d: res_one(k, z, d))(z))(ks)                           # (F,9,15)
    W = jax.vmap(info_from_cov)(f.C[:, :9, :9])                       # (F,9,9)
    w_edge = f.valid.astype(jnp.float32) * \
        (~prob.cam_fixed[f.kf_i] | ~prob.cam_fixed[f.kf_j]).astype(jnp.float32)
    # zero jacobians of fixed endpoints
    Ji = Ji * (~prob.cam_fixed)[f.kf_i].astype(jnp.float32)[:, None, None]
    Jj = Jj * (~prob.cam_fixed)[f.kf_j].astype(jnp.float32)[:, None, None]

    # bias random walk: r = b_j - b_i, info from C[9:15,9:15]^-1
    rb = bias[f.kf_j] - bias[f.kf_i]                                  # (F,6)
    Cw = f.C[:, 9:15, 9:15] + jnp.eye(6)[None] * 1e-12
    Wb = jnp.linalg.inv(Cw)
    return r, Ji, Jj, W, w_edge, rb, Wb


def vi_bundle_adjust(prob: VIProblem, cam_model: str, cam_params,
                     iterations: int = 10, lam0: float = 1e-5,
                     use_robust: bool = True,
                     bias_prior: float = 0.0,
                     pcg_iters: int = 24,
                     schur: str = "pcg") -> VIBAResult:
    """Joint LM over body states + points (FullInertialBA semantics).

    `pcg_iters`: reduced-system PCG steps per LM iteration.  Each
    matrix-free step is ~15 dependent kernels of pure device latency;
    with the exact block-Jacobi preconditioner a window-sized system
    (K <= 16) converges in well under 16 steps (the original fixed 48
    was the single largest item of the 182 ms inertial window BA).

    `schur="dense"`: assemble the (15K, 15K) reduced system explicitly
    (visual part via the Cholesky-split G G^T matmul, inertial/bias-RW
    pair blocks scattered) and run the PCG with ONE-matmul matvecs —
    same lesson as the visual window BA's grid solver: at window sizes
    the matrix-free matvec's kernel chain is pure latency.  Memory is
    the (K, P, 15, 3) split tensor — right for windows (K <= ~64), not
    for capacity-sized maps."""
    K = prob.Rwb.shape[0]
    P = prob.X.shape[0]
    f = prob.factors

    def build_and_solve(Rwb, pwb, vel, bias, X, lam):
        e, Jc6, Jp, w, chi2, m = _reproj_terms(
            prob, Rwb, pwb, X, cam_model, cam_params, use_robust)
        O = e.shape[0]
        # lift (O,2,6) -> (O,2,15)
        Jc = jnp.concatenate(
            [Jc6, jnp.zeros((O, 2, STATE_DIM - 6))], axis=-1)
        wJc = Jc * w[:, None, None]
        Hcc = jnp.zeros((K, STATE_DIM, STATE_DIM)).at[prob.obs_cam].add(
            jnp.einsum("nik,nil->nkl", wJc, Jc, precision=_HI))
        bc = jnp.zeros((K, STATE_DIM)).at[prob.obs_cam].add(
            -jnp.einsum("nik,ni->nk", wJc, e, precision=_HI))
        wJp = Jp * w[:, None, None]
        Hpp = jnp.zeros((P, 3, 3)).at[prob.obs_pt].add(
            jnp.einsum("nik,nil->nkl", wJp, Jp, precision=_HI))
        bp = jnp.zeros((P, 3)).at[prob.obs_pt].add(
            -jnp.einsum("nik,ni->nk", wJp, e, precision=_HI))
        # camera-point coupling kept per observation (no (K,P) tensor)
        Cobs = jnp.einsum("nik,nil->nkl", wJc, Jp, precision=_HI)  # (O,15,3)

        # inertial terms (per-factor pair blocks, applied in the matvec)
        r_in, Ji, Jj, W, w_edge, rb, Wb = _inertial_terms(
            prob, Rwb, pwb, vel, bias)
        Wr = jnp.einsum("fab,fb->fa", W, r_in, precision=_HI)
        bc = bc.at[f.kf_i].add(
            -w_edge[:, None] * jnp.einsum("fak,fa->fk", Ji, Wr,
                                          precision=_HI))
        bc = bc.at[f.kf_j].add(
            -w_edge[:, None] * jnp.einsum("fak,fa->fk", Jj, Wr,
                                          precision=_HI))
        # bias RW edges: d rb / d bias_i = -I, / d bias_j = +I on dims 9:15
        Wrb = jnp.einsum("fab,fb->fa", Wb, rb, precision=_HI)
        bc = bc.at[f.kf_i, 9:15].add(w_edge[:, None] * Wrb)
        bc = bc.at[f.kf_j, 9:15].add(-w_edge[:, None] * Wrb)
        if bias_prior > 0:
            Hcc = Hcc.at[:, 9:15, 9:15].add(jnp.eye(6)[None] * bias_prior)
            bc = bc.at[:, 9:15].add(-bias_prior * bias)

        # ---- reduced system (matrix-free PCG or dense window solve)
        free = (~prob.cam_fixed).astype(jnp.float32)
        gi = free[f.kf_i] * w_edge
        gj = free[f.kf_j] * w_edge
        Hcc_d = Hcc + lam * jnp.eye(STATE_DIM)[None]
        Hpp_d = Hpp + lam * jnp.eye(3)[None]
        pt_on = prob.pt_valid.astype(jnp.float32)[:, None, None]
        Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
        Hpp_inv = _spd_inv3(Hpp_d)
        CW = jnp.einsum("nij,njl->nil", Cobs, Hpp_inv[prob.obs_pt],
                        precision=_HI)
        # current cost from the already-computed residuals (the old code
        # re-ran the full linearization just to price the current state)
        cur = _robust_cost(chi2, m, use_robust) + \
            _inertial_cost(r_in, W, rb, Wb, w_edge)

        if schur == "dense":
            from .ba import _chol3
            D = STATE_DIM
            L = _chol3(Hpp_inv)
            U = jnp.einsum("nij,njl->nil", Cobs, L[prob.obs_pt],
                           precision=_HI)
            G = jnp.zeros((K, P, D, 3)).at[prob.obs_cam,
                                           prob.obs_pt].add(U)
            Gr = G.transpose(0, 2, 1, 3).reshape(K * D, P * 3)
            S = -jnp.dot(Gr, Gr.T, precision=_HI).reshape(K, D, K, D)
            S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hcc_d)
            # inertial pair blocks (Gauss-Newton of the whitened edge)
            WJi = jnp.einsum("fab,fbk->fak", W, Ji, precision=_HI)
            WJj = jnp.einsum("fab,fbk->fak", W, Jj, precision=_HI)
            we = w_edge[:, None, None]
            S = S.at[f.kf_i, :, f.kf_i, :].add(
                we * jnp.einsum("fak,fal->fkl", Ji, WJi, precision=_HI))
            S = S.at[f.kf_j, :, f.kf_j, :].add(
                we * jnp.einsum("fak,fal->fkl", Jj, WJj, precision=_HI))
            S = S.at[f.kf_i, :, f.kf_j, :].add(
                we * jnp.einsum("fak,fal->fkl", Ji, WJj, precision=_HI))
            S = S.at[f.kf_j, :, f.kf_i, :].add(
                we * jnp.einsum("fak,fal->fkl", Jj, WJi, precision=_HI))
            # bias random-walk blocks on dims 9:15
            bb = we * Wb
            S = S.at[f.kf_i, 9:15, f.kf_i, 9:15].add(
                bb * (gi * gi)[:, None, None])
            S = S.at[f.kf_j, 9:15, f.kf_j, 9:15].add(
                bb * (gj * gj)[:, None, None])
            S = S.at[f.kf_i, 9:15, f.kf_j, 9:15].add(
                -bb * (gi * gj)[:, None, None])
            S = S.at[f.kf_j, 9:15, f.kf_i, 9:15].add(
                -bb * (gi * gj)[:, None, None])
            # fixed cameras: identity rows/cols
            ff_ = free[:, None, None, None] * free[None, None, :, None]
            S = S * ff_
            S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(
                jnp.eye(D)[None] * (1 - free)[:, None, None])
            rv = jnp.einsum("nil,nl->ni", CW, bp[prob.obs_pt],
                            precision=_HI)
            rhs = (bc - jnp.zeros((K, D)).at[prob.obs_cam].add(rv)) * \
                free[:, None]
            Dg = S[jnp.arange(K), :, jnp.arange(K), :] + \
                jnp.eye(D)[None] * 1e-8
            D_inv = jnp.linalg.inv(Dg)

            def mv_d(x):
                y = jnp.einsum("kilj,lj->ki", S, x, precision=_HI)
                return y * free[:, None] + x * (1 - free)[:, None]

            def prec_d(r):
                return jnp.einsum("kij,kj->ki", D_inv, r, precision=_HI)

            x0 = jnp.zeros((K, D))
            z0 = prec_d(rhs)

            def pcg_d(carry, _):
                x, r, z, pv = carry
                Ap = mv_d(pv)
                rz = jnp.sum(r * z)
                den = jnp.sum(pv * Ap)
                al = rz / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
                x2 = x + al * pv
                r2 = r - al * Ap
                z2 = prec_d(r2)
                be = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20,
                                                  1e-20, rz)
                return (x2, r2, z2, z2 + be * pv), None

            (dx_cam, _, _, _), _ = jax.lax.scan(
                pcg_d, (x0, rhs, z0, z0), None, length=pcg_iters)
            dx_cam = dx_cam * free[:, None]
            u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[prob.obs_cam],
                           precision=_HI)
            sscat = jnp.zeros((P, 3)).at[prob.obs_pt].add(u)
            dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - sscat,
                               precision=_HI)
            dx_pt = dx_pt * prob.pt_valid.astype(jnp.float32)[:, None]
            return dx_cam, dx_pt, cur

        def S_matvec(x):
            xm = x * free[:, None]
            y = jnp.einsum("kij,kj->ki", Hcc_d, xm, precision=_HI)
            # visual Schur term
            u = jnp.einsum("nij,ni->nj", Cobs, xm[prob.obs_cam],
                           precision=_HI)
            s = jnp.zeros((P, 3)).at[prob.obs_pt].add(u)
            v = jnp.einsum("nil,nl->ni", CW, s[prob.obs_pt], precision=_HI)
            y = y - jnp.zeros((K, STATE_DIM)).at[prob.obs_cam].add(v)
            # inertial pair blocks
            ai = jnp.einsum("fak,fk->fa", Ji, xm[f.kf_i], precision=_HI)
            aj = jnp.einsum("fak,fk->fa", Jj, xm[f.kf_j], precision=_HI)
            tw = jnp.einsum("fab,fb->fa", W, ai + aj,
                            precision=_HI) * w_edge[:, None]
            y = y.at[f.kf_i].add(
                jnp.einsum("fak,fa->fk", Ji, tw, precision=_HI))
            y = y.at[f.kf_j].add(
                jnp.einsum("fak,fa->fk", Jj, tw, precision=_HI))
            # bias random walk pair blocks
            db = (xm[f.kf_j, 9:15] * gj[:, None] -
                  xm[f.kf_i, 9:15] * gi[:, None])
            tb = jnp.einsum("fab,fb->fa", Wb, db,
                            precision=_HI) * w_edge[:, None]
            y = y.at[f.kf_i, 9:15].add(-tb * gi[:, None])
            y = y.at[f.kf_j, 9:15].add(tb * gj[:, None])
            return y * free[:, None] + x * (1 - free)[:, None]

        # rhs = bc - C Hpp_inv bp
        rv = jnp.einsum("nil,nl->ni", CW, bp[prob.obs_pt], precision=_HI)
        rhs = (bc - jnp.zeros((K, STATE_DIM)).at[prob.obs_cam].add(rv)) * \
            free[:, None]

        # exact block-diagonal preconditioner
        D = Hcc_d - jnp.zeros((K, STATE_DIM, STATE_DIM)).at[
            prob.obs_cam].add(
            jnp.einsum("nil,nml->nim", CW, Cobs, precision=_HI))
        WJi = jnp.einsum("fab,fbk->fak", W, Ji, precision=_HI)
        WJj = jnp.einsum("fab,fbk->fak", W, Jj, precision=_HI)
        we = w_edge[:, None, None]
        D = D.at[f.kf_i].add(
            we * jnp.einsum("fak,fal->fkl", Ji, WJi, precision=_HI))
        D = D.at[f.kf_j].add(
            we * jnp.einsum("fak,fal->fkl", Jj, WJj, precision=_HI))
        D = D.at[f.kf_i, 9:15, 9:15].add(we * Wb * gi[:, None, None])
        D = D.at[f.kf_j, 9:15, 9:15].add(we * Wb * gj[:, None, None])
        D = D * free[:, None, None] + \
            jnp.eye(STATE_DIM)[None] * (1 - free)[:, None, None]
        D = D + jnp.eye(STATE_DIM)[None] * 1e-8
        D_inv = jnp.linalg.inv(D)

        def precond(r):
            return jnp.einsum("kij,kj->ki", D_inv, r, precision=_HI)

        x0 = jnp.zeros((K, STATE_DIM))
        r0 = rhs
        z0 = precond(r0)

        def pcg_step(carry, _):
            x, r, z, p = carry
            Ap = S_matvec(p)
            rz = jnp.sum(r * z)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
            x2 = x + alpha * p
            r2 = r - alpha * Ap
            z2 = precond(r2)
            beta = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20,
                                                1e-20, rz)
            return (x2, r2, z2, z2 + beta * p), None

        (dx_cam, _, _, _), _ = jax.lax.scan(
            pcg_step, (x0, r0, z0, z0), None, length=pcg_iters)
        dx_cam = dx_cam * free[:, None]

        u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[prob.obs_cam],
                       precision=_HI)
        s = jnp.zeros((P, 3)).at[prob.obs_pt].add(u)
        dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - s, precision=_HI)
        dx_pt = dx_pt * prob.pt_valid.astype(jnp.float32)[:, None]
        return dx_cam, dx_pt, cur

    def _robust_cost(chi2, m, rob):
        if rob:
            cr = jnp.where(
                jnp.sqrt(jnp.maximum(chi2, 1e-12)) <= robust.HUBER_MONO,
                chi2, 2 * robust.HUBER_MONO * jnp.sqrt(
                    jnp.maximum(chi2, 1e-12)) - robust.CHI2_MONO)
        else:
            cr = chi2
        return jnp.sum(cr * m.astype(jnp.float32))

    def _inertial_cost(r_in, W, rb, Wb, w_edge):
        c_in = jnp.sum(w_edge * jnp.einsum(
            "fa,fab,fb->f", r_in, W, r_in, precision=_HI))
        c_rw = jnp.sum(w_edge * jnp.einsum(
            "fa,fab,fb->f", rb, Wb, rb, precision=_HI))
        return c_in + c_rw

    def total_cost(Rwb, pwb, vel, bias, X):
        """Residuals-only cost (no Jacobian work — accept/reject test)."""
        e, chi2, m = _reproj_residuals(
            prob, Rwb, pwb, X, cam_model, cam_params, use_robust)
        r_in, W, w_edge, rb, Wb = _inertial_residuals(
            prob, Rwb, pwb, vel, bias)
        return _robust_cost(chi2, m, use_robust) + \
            _inertial_cost(r_in, W, rb, Wb, w_edge)

    def step(carry, _):
        Rwb, pwb, vel, bias, X, lam, _ = carry
        dx_cam, dx_pt, cur = build_and_solve(Rwb, pwb, vel, bias, X, lam)
        R2, p2, v2, b2 = apply_delta(Rwb, pwb, vel, bias, dx_cam)
        R2 = lie.normalize_rotation(R2)
        X2 = X + dx_pt
        new = total_cost(R2, p2, v2, b2, X2)
        ok = new < cur
        Rwb = jnp.where(ok, R2, Rwb)
        pwb = jnp.where(ok, p2, pwb)
        vel = jnp.where(ok, v2, vel)
        bias = jnp.where(ok, b2, bias)
        X = jnp.where(ok, X2, X)
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-9, 1e9)
        return (Rwb, pwb, vel, bias, X, lam, jnp.minimum(new, cur)), None

    init = (prob.Rwb, prob.pwb, prob.vel, prob.bias, prob.X,
            jnp.asarray(lam0, jnp.float32), jnp.asarray(jnp.inf, jnp.float32))
    (Rwb, pwb, vel, bias, X, _, cost), _ = jax.lax.scan(
        step, init, None, length=iterations)
    return VIBAResult(Rwb=Rwb, pwb=pwb, vel=vel, bias=bias, X=X, cost=cost)

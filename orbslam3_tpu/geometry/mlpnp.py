"""MLPnP: maximum-likelihood PnP in bearing-vector nullspace form.

Parity target: reference MLPnPsolver (src/MLPnPsolver.cpp, the Urban et
al. 2016 algorithm; RANSAC params at src/Tracking.cc:839).  This is the
actual MLPnP formulation — not the DLT stand-in in geometry/pnp.py:

  * each observation is a unit BEARING v_i (from the camera model's
    unprojection — exact for fisheye, where pixel-space DLT degrades);
  * the measurement model is the 2-D tangent-space (nullspace) residual
    J(v_i)^T u_i with u_i = (R X_i + t)/|R X_i + t| and J(v) = [r, s] an
    orthonormal basis of v's orthogonal complement
    (MLPnPsolver.h nullspace construction);
  * the linear initialization solves the stacked nullspace constraints
    J(v_i)^T (R X_i + t) = 0 — 12 unknowns [vec R | t] in the general
    case, 9 when the point set is planar (third R column unobservable;
    recovered by the cross product) — via the smallest eigenvector of
    the 12x12 / 9x9 Gram matrix;
  * maximum likelihood: residuals weighted by the bearing-tangent
    covariance propagated from the per-keypoint pixel covariance
    (octave noise model), then Gauss-Newton refinement with chi2
    inlier reclassification.

Design: all RANSAC hypotheses solve in parallel (vmapped batched
eigh of tiny Grams — no data-dependent control flow); both the planar
and general linear forms are computed for every sample and the globally
estimated planarity selects between them (two tiny batched solves beat
a traced branch).  Refinement is batched GN with jacfwd over the
(omega, t) chart.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie
from ..solver import robust

_HI = jax.lax.Precision.HIGHEST


class MLPnPResult(NamedTuple):
    success: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def bearing_nullspace(v: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) unit bearings -> (N, 3, 2) orthonormal tangent bases J(v)
    (the nullspace of v^T).  Householder-style: cross with the axis
    least aligned with v (branch-free where)."""
    ez = jnp.asarray([0.0, 0.0, 1.0])
    ex = jnp.asarray([1.0, 0.0, 0.0])
    use_z = jnp.abs(v[:, 2:3]) < 0.9
    a = jnp.where(use_z, ez[None, :], ex[None, :])
    r = jnp.cross(v, a)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=1, keepdims=True), 1e-12)
    s = jnp.cross(v, r)
    return jnp.stack([r, s], axis=-1)


def _smallest_eigvec(G: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a symmetric (D, D)."""
    _, V = jnp.linalg.eigh(G)
    return V[:, 0]


def _fix_pose(M: jnp.ndarray, t: jnp.ndarray):
    """Common tail of both linear forms: det-normalize the raw [M | t]
    estimate (this also canonicalizes the eigenvector's sign ambiguity
    — [-M|-t] normalizes to the same pose) and project M to SO(3).
    Mirrored minimal-sample solutions place points behind their
    bearings and are killed by the cheirality term in scoring."""
    det = jnp.linalg.det(M)
    scale = jnp.sign(det) * jnp.cbrt(jnp.abs(det) + 1e-20)
    scale = jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return lie.normalize_rotation_svd(M / scale), t / scale


def _solve_general(X: jnp.ndarray, J: jnp.ndarray):
    """12-unknown nullspace DLT on one sample: rows J^T (R X + t) = 0."""
    S = X.shape[0]
    # row for tangent direction d: sum_jk d_j X_k R_jk + d_j t_j
    d = jnp.concatenate([J[:, :, 0], J[:, :, 1]], axis=0)   # (2S, 3)
    Xr = jnp.concatenate([X, X], axis=0)                     # (2S, 3)
    A_R = (d[:, :, None] * Xr[:, None, :]).reshape(2 * S, 9)
    A = jnp.concatenate([A_R, d], axis=1)                    # (2S, 12)
    G = jnp.matmul(A.T, A, precision=_HI)
    u = _smallest_eigvec(G)
    return _fix_pose(u[:9].reshape(3, 3), u[9:12])


def _solve_planar(X: jnp.ndarray, J: jnp.ndarray,
                  E: jnp.ndarray, c: jnp.ndarray):
    """9-unknown planar form: points rotated into the plane basis E
    (third coordinate ~0), so only R's first two columns enter."""
    Xp = jnp.matmul(X - c[None, :], E, precision=_HI)        # (S, 3)
    S = X.shape[0]
    d = jnp.concatenate([J[:, :, 0], J[:, :, 1]], axis=0)
    Xr = jnp.concatenate([Xp, Xp], axis=0)
    A_R = (d[:, :, None] * Xr[:, None, :2]).reshape(2 * S, 6)
    A = jnp.concatenate([A_R, d], axis=1)                    # (2S, 9)
    G = jnp.matmul(A.T, A, precision=_HI)
    u = _smallest_eigvec(G)
    # u[:6] reshaped (3, 2) j-major = the first two columns of s*R;
    # the third column (s*r1 x s*r2 = s^2 * r3) is rescaled back to s
    M2 = u[:6].reshape(3, 2)
    s_est = jnp.sqrt(jnp.linalg.norm(M2[:, 0]) *
                     jnp.linalg.norm(M2[:, 1]) + 1e-20)
    c3 = jnp.cross(M2[:, 0], M2[:, 1]) / jnp.maximum(s_est, 1e-12)
    Rp, tp = _fix_pose(jnp.concatenate([M2, c3[:, None]], axis=1),
                       u[6:9])
    # undo the plane basis: x_c = Rp (E^T (X - c)) + tp
    R = jnp.matmul(Rp, E.T, precision=_HI)
    t = tp - R @ c
    return R, t


def _nullspace_residuals(R, t, X, J, f_scale):
    """(N, 2) tangent-space residuals of unit-projected points, scaled
    by the focal length so magnitudes are pixel-comparable."""
    Xc = lie.se3_apply(R, t, X)
    u = Xc / jnp.maximum(jnp.linalg.norm(Xc, axis=1, keepdims=True), 1e-9)
    return f_scale * jnp.einsum("njk,nj->nk", J, u)


def solve_mlpnp(X: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
                cam_model: str, cam_params, key,
                iterations: int = 256, sample: int = 6,
                chi2_th: float = 5.991, min_inliers: int = 30,
                inv_sigma2=None, gn_rounds: int = 3,
                gn_iters: int = 6) -> MLPnPResult:
    """RANSAC MLPnP + ML Gauss-Newton refinement.

    X (N,3) world points matched to uv (N,2) pixels; `inv_sigma2` the
    per-keypoint inverse pixel variance (octave noise model).  Bearing
    covariance = pixel covariance / f^2; residuals are f-scaled so
    chi2_th keeps its pixel-space meaning."""
    n = X.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones(n)
    cam_params = jnp.asarray(cam_params, jnp.float32)
    f_scale = cam_params[0]
    rays = cameras.unproject(cam_model, cam_params, uv)
    v = rays / jnp.maximum(jnp.linalg.norm(rays, axis=1, keepdims=True),
                           1e-9)
    J = bearing_nullspace(v)

    # global planarity of the valid point set (reference MLPnP
    # eigen-decomposes the point scatter to pick the planar path)
    w = valid.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(X * w[:, None], axis=0) / wsum
    Xc_ = (X - c) * w[:, None]
    S3 = jnp.matmul(Xc_.T, Xc_, precision=_HI) / wsum
    evals, E = jnp.linalg.eigh(S3)           # ascending
    planar = evals[0] < 1e-3 * jnp.maximum(evals[2], 1e-12)
    # plane basis: largest two eigenvectors first, normal last
    E_plane = jnp.stack([E[:, 2], E[:, 1], E[:, 0]], axis=1)

    # importance-sample minimal sets toward low-noise observations
    # (ML prior: a hypothesis from sigma=1 px points scores far better
    # than one from sigma=3.6 px points; outliers are octave-uniform so
    # this does not bias the inlier odds)
    wp = w * inv_sigma2 + 1e-9
    idx = jax.random.categorical(
        key, jnp.log(wp)[None, :].repeat(iterations * sample, 0)
    ).reshape(iterations, sample)

    def _gn_sample(R, t, Xs, Js):
        """Plain GN on the minimal sample (reference mlpnp_gn inside
        computePose): the exactly-determined linear solve is
        noise-fragile; 3 Newton steps on the sample make an all-inlier
        draw actually score like one."""
        def it(carry, _):
            Rc, tc = carry

            def res(dx):
                R2 = jnp.matmul(Rc, lie.exp_so3(dx[0:3]), precision=_HI)
                return _nullspace_residuals(
                    R2, tc + dx[3:6], Xs, Js, f_scale).reshape(-1)

            x0 = jnp.zeros(6)
            r0 = res(x0)
            Jr = jax.jacfwd(res)(x0)
            H = jnp.matmul(Jr.T, Jr, precision=_HI) + 1e-5 * jnp.eye(6)
            dx = jnp.linalg.solve(H, -jnp.matmul(Jr.T, r0, precision=_HI))
            R2 = lie.normalize_rotation(
                jnp.matmul(Rc, lie.exp_so3(dx[0:3]), precision=_HI))
            return (R2, tc + dx[3:6]), None

        (Rf, tf), _ = jax.lax.scan(it, (R, t), None, length=3)
        return Rf, tf

    def hyp(s):
        Rg, tg = _solve_general(X[s], J[s])
        Rp, tp = _solve_planar(X[s], J[s], E_plane, c)
        R = jnp.where(planar, Rp, Rg)
        t = jnp.where(planar, tp, tg)
        return _gn_sample(R, t, X[s], J[s])

    Rs, ts = jax.vmap(hyp)(idx)

    def score(R, t):
        e = _nullspace_residuals(R, t, X, J, f_scale)
        chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
        depth_ok = jnp.einsum("nj,nj->n", v, lie.se3_apply(R, t, X)) > 0.01
        ok = (chi2 < 4.0 * chi2_th) & valid & depth_ok
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, inls = jax.vmap(score)(Rs, ts)
    # LO-RANSAC: refine the top-k scoring hypotheses, keep the one with
    # the most final inliers — a 5/6-inlier sample's near-pose is often
    # rescued by the GN polish, which matters at the reference's fixed
    # maxIts=300 once the outlier rate passes ~50%
    topk = 8
    _, cand = jax.lax.top_k(counts, topk)

    # ---- ML refinement: GN over (omega, t) with chi2 reclassification
    def gn(R, t, active):
        aw = active.astype(jnp.float32) * inv_sigma2

        def it(carry, _):
            Rc, tc = carry
            # IRLS: robust weights frozen at the current iterate (they
            # must NOT be differentiated — jacfwd through sqrt(w) at
            # w=0 poisons the jacobian with NaNs)
            e0 = _nullspace_residuals(Rc, tc, X, J, f_scale)
            hub = robust.huber_weight(
                jnp.sum(e0 * e0, axis=-1) * inv_sigma2,
                jnp.sqrt(chi2_th))
            sw = jnp.sqrt(aw * hub)[:, None]

            def res_c(dx):
                R2 = jnp.matmul(Rc, lie.exp_so3(dx[0:3]), precision=_HI)
                t2 = tc + dx[3:6]
                e = _nullspace_residuals(R2, t2, X, J, f_scale)
                return (e * sw).reshape(-1)

            x0 = jnp.zeros(6)
            r0 = res_c(x0)
            Jr = jax.jacfwd(res_c)(x0)
            H = jnp.matmul(Jr.T, Jr, precision=_HI) + 1e-6 * jnp.eye(6)
            g = -jnp.matmul(Jr.T, r0, precision=_HI)
            dx = jnp.linalg.solve(H, g)
            R2 = lie.normalize_rotation(
                jnp.matmul(Rc, lie.exp_so3(dx[0:3]), precision=_HI))
            return (R2, tc + dx[3:6]), None

        (Rf, tf), _ = jax.lax.scan(it, (R, t), None, length=gn_iters)
        return Rf, tf

    def refine(R, t, inl):
        for _ in range(gn_rounds):
            R, t = gn(R, t, inl)
            e = _nullspace_residuals(R, t, X, J, f_scale)
            chi2 = jnp.sum(e * e, axis=-1) * inv_sigma2
            depth_ok = jnp.einsum(
                "nj,nj->n", v, lie.se3_apply(R, t, X)) > 0.01
            inl = (chi2 < chi2_th) & valid & depth_ok
        return R, t, inl, jnp.sum(inl.astype(jnp.int32))

    Rf, tf, inlf, nf = jax.vmap(refine)(Rs[cand], ts[cand], inls[cand])
    b = jnp.argmax(nf)
    n_inl = nf[b]
    return MLPnPResult(success=n_inl >= min_inliers, R=Rf[b], t=tf[b],
                       inliers=inlf[b], n_inliers=n_inl)

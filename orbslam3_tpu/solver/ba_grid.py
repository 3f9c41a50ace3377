"""Grid-dense local bundle adjustment: the window problem as a (P, K)
observation grid instead of a COO list.

Parity target: reference LocalBundleAdjustment (src/Optimizer.cc:1069-1360)
— same window semantics, LM schedule and Huber gating as solver/ba.py.

Design rationale (16 cams / 4096 pts / 12288 obs): the COO formulation
spends its LM iteration on scatter-adds for Hcc/Hpp/G, per-observation
(O,2,3)x(O,3,6) batched tiny dot_generals, and a re-materialized
(K*P,6,3) coupling buffer.  A window map
point is observed AT MOST ONCE per keyframe, so the problem is naturally
a dense (P, K) grid:

  * residuals/Jacobians broadcast over the grid — no index gathers;
  * every small-dim contraction (6x3 block products) is unrolled into
    (P, K) plane arithmetic that XLA fuses into a handful of elementwise
    kernels — no batched tiny matmuls;
  * the two big contractions (Hcc over p*r, S_off over p*3) become real
    matmuls with contraction length in the thousands;
  * the camera-point coupling IS the grid — the (K,P,6,3) tensor the COO
    path scattered into is produced directly, and the reduced system is
    solved by the unrolled block Cholesky (ops/smallsolve).

Empty grid slots carry weight 0; fixed cameras carry zeroed camera
Jacobians and identity rows in the reduced system.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, smallsolve
from . import robust
from .ba import _chol3, _spd_inv3

_HI = jax.lax.Precision.HIGHEST


class GridBAProblem(NamedTuple):
    """Dense-window BA problem: one observation slot per (point, camera)."""
    R: jnp.ndarray            # (K, 3, 3) R_cw
    t: jnp.ndarray            # (K, 3)
    cam_fixed: jnp.ndarray    # (K,) bool
    cam_valid: jnp.ndarray    # (K,) bool
    X: jnp.ndarray            # (P, 3)
    pt_valid: jnp.ndarray     # (P,) bool
    uv: jnp.ndarray           # (P, K, 2)
    inv_sigma2: jnp.ndarray   # (P, K)
    valid: jnp.ndarray        # (P, K) bool — slot occupied
    ur: jnp.ndarray           # (P, K) stereo right-u, -1 = mono


def _hat_apply(A, x):
    """A @ hat(x) for A (..., r, 3), x (..., 3) -> (..., r, 3), unrolled.

    hat(x) columns: (0, x2, -x1), (-x2, 0, x0), (x1, -x0, 0).
    """
    x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    c0 = A[..., 1] * x2 - A[..., 2] * x1
    c1 = -A[..., 0] * x2 + A[..., 2] * x0
    c2 = A[..., 0] * x1 - A[..., 1] * x0
    return jnp.stack([c0, c1, c2], axis=-1)


def _grid_residuals(prob: GridBAProblem, R, t, X, cam_model, cam_params,
                    stereo_bf: float):
    """e (P,K,r), Xc (P,K,3) with r = 2 (mono) or 3 (stereo row)."""
    Xc = jnp.einsum("kab,pb->pka", R, X, precision=_HI) + t[None]
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.uv - uvp
    if stereo_bf > 0.0:
        z = jnp.maximum(Xc[..., 2], 1e-6)
        ur_pred = uvp[..., 0] - stereo_bf / z
        has_d = prob.ur >= 0
        e3 = jnp.where(has_d, prob.ur - ur_pred, 0.0)
        e = jnp.concatenate([e, e3[..., None]], axis=-1)
    return e, Xc


def _grid_jacobians(prob: GridBAProblem, R, t, X, cam_model, cam_params,
                    stereo_bf: float):
    """e (P,K,r), Jc (P,K,r,6), Jp (P,K,r,3) — all plane arithmetic."""
    Xc = jnp.einsum("kab,pb->pka", R, X, precision=_HI) + t[None]
    uvp = cameras.project(cam_model, cam_params, Xc)
    e = prob.uv - uvp
    Jproj = cameras.project_jac(cam_model, cam_params, Xc)   # (P,K,2,3)
    if stereo_bf > 0.0:
        z = jnp.maximum(Xc[..., 2], 1e-6)
        ur_pred = uvp[..., 0] - stereo_bf / z
        has_d = prob.ur >= 0
        e3 = jnp.where(has_d, prob.ur - ur_pred, 0.0)
        e = jnp.concatenate([e, e3[..., None]], axis=-1)
        w3 = has_d.astype(jnp.float32)
        Jur = jnp.stack([Jproj[..., 0, 0] * w3,
                         Jproj[..., 0, 1] * w3,
                         (Jproj[..., 0, 2] + stereo_bf / (z * z)) * w3],
                        axis=-1)
        Jproj = jnp.concatenate([Jproj, Jur[..., None, :]], axis=-2)
    # Jc = -Jproj @ [I | -hat(Xc)] = [-Jproj | Jproj @ hat(Xc)]
    Jc = jnp.concatenate([-Jproj, _hat_apply(Jproj, Xc)], axis=-1)
    # Jp = -Jproj @ R[k]: contraction over 3, unrolled into planes
    Jp = -(Jproj[..., 0:1] * R[None, :, None, 0, :] +
           Jproj[..., 1:2] * R[None, :, None, 1, :] +
           Jproj[..., 2:3] * R[None, :, None, 2, :])
    return e, Jc, Jp


def _weights(prob: GridBAProblem, e, chi2_th, use_robust):
    chi2 = jnp.sum(e * e, axis=-1) * prob.inv_sigma2
    w_rob = robust.huber_weight(chi2, chi2_th ** 0.5) if use_robust else 1.0
    msk = (prob.valid & prob.pt_valid[:, None] & prob.cam_valid[None, :]
           ).astype(jnp.float32)
    return prob.inv_sigma2 * w_rob * msk, chi2, msk


def _huber_cost(chi2, delta):
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(e <= delta, chi2, 2 * delta * e - delta * delta)


def _grid_cost(prob, R, t, X, cam_model, cam_params, chi2_th, use_robust,
               stereo_bf):
    e, _ = _grid_residuals(prob, R, t, X, cam_model, cam_params, stereo_bf)
    chi2 = jnp.sum(e * e, axis=-1) * prob.inv_sigma2
    msk = (prob.valid & prob.pt_valid[:, None] & prob.cam_valid[None, :]
           ).astype(jnp.float32)
    c = _huber_cost(chi2, chi2_th ** 0.5) if use_robust else chi2
    return jnp.sum(c * msk)


def _plane_outer(A, B, wA=None):
    """sum_i A[..., i, a] * B[..., i, b] -> (..., nA, nB), unrolled.

    A (..., r, nA), B (..., r, nB); wA optional (...,) weight folded into
    A.  Returns plane-stacked blocks (no batched tiny dot_general)."""
    r, nA = A.shape[-2], A.shape[-1]
    nB = B.shape[-1]
    rows = []
    for a in range(nA):
        cols = []
        for b in range(nB):
            s = A[..., 0, a] * B[..., 0, b]
            for i in range(1, r):
                s = s + A[..., i, a] * B[..., i, b]
            if wA is not None:
                s = s * wA
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def _block_mul(C, M):
    """C (..., a, b) @ M (..., b, c) -> (..., a, c) unrolled over small
    dims; M broadcasts against C's leading dims."""
    a, b = C.shape[-2], C.shape[-1]
    c = M.shape[-1]
    rows = []
    for i in range(a):
        cols = []
        for j in range(c):
            s = C[..., i, 0] * M[..., 0, j]
            for k in range(1, b):
                s = s + C[..., i, k] * M[..., k, j]
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def _grid_step(prob: GridBAProblem, R, t, X, lam, cam_model, cam_params,
               chi2_th, use_robust, stereo_bf):
    """One LM step: returns (dx_cam (K,6), dx_pt (P,3), current cost)."""
    P, K = prob.uv.shape[0], prob.R.shape[0]
    e, Jc, Jp = _grid_jacobians(prob, R, t, X, cam_model, cam_params,
                                stereo_bf)
    w, chi2, msk = _weights(prob, e, chi2_th, use_robust)
    free = (~prob.cam_fixed).astype(jnp.float32)
    Jc = Jc * free[None, :, None, None]
    r = e.shape[-1]

    # ---- camera system: one matmul per K batch, e appended as an
    # extra column so Hcc and bc come out of the same contraction
    wJc = Jc * w[..., None, None]
    Je = jnp.concatenate([Jc, e[..., None]], axis=-1)        # (P,K,r,7)
    lhs = wJc.transpose(1, 3, 0, 2).reshape(K, 6, P * r)
    rhsm = Je.transpose(1, 0, 2, 3).reshape(K, P * r, 7)
    Hb = jax.lax.dot_general(lhs, rhsm, (((2,), (1,)), ((0,), (0,))),
                             precision=_HI)                  # (K, 6, 7)
    Hcc = Hb[:, :, :6]
    bc = -Hb[:, :, 6]

    # ---- point system: plane reductions over (k, i)
    wJp = Jp * w[..., None, None]
    Hpp = jnp.sum(_plane_outer(wJp, Jp), axis=1)             # (P, 3, 3)
    bp = -jnp.sum(
        jnp.stack([jnp.sum(wJp[..., a] * e, axis=-1) for a in range(3)],
                  axis=-1), axis=1)                          # (P, 3)

    # ---- coupling grid: C[p,k] = Jc^T W Jp (6,3) — plane products
    C = _plane_outer(wJc, Jp)                                # (P, K, 6, 3)

    cost = jnp.sum(jnp.where(use_robust, _huber_cost(chi2, chi2_th ** 0.5),
                             chi2) * msk)

    # ---- Schur: S = Hcc_d - U U^T with U = C @ chol(Hpp_d^-1)
    Hcc_d = Hcc + lam * jnp.eye(6)[None]
    Hpp_d = Hpp + lam * jnp.eye(3)[None]
    pt_on = prob.pt_valid.astype(jnp.float32)[:, None, None]
    Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
    Hpp_inv = _spd_inv3(Hpp_d)
    L = _chol3(Hpp_inv)
    U = _block_mul(C, L[:, None])                            # (P, K, 6, 3)
    Ur = U.transpose(1, 2, 0, 3).reshape(K * 6, P * 3)
    S_off = jnp.dot(Ur, Ur.T, precision=_HI).reshape(K, 6, K, 6)

    CW = _block_mul(C, Hpp_inv[:, None])                     # (P, K, 6, 3)
    rv = jnp.sum(CW * bp[:, None, None, :], axis=-1)         # (P, K, 6)
    rhs = (bc - jnp.sum(rv, axis=0)) * free[:, None]

    S = jnp.zeros((K, 6, K, 6))
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hcc_d)
    S = S - S_off
    ff = free[:, None, None, None] * free[None, None, :, None]
    S = S * ff
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(
        jnp.eye(6)[None] * (1 - free)[:, None, None])
    dx_cam = smallsolve.solve_psd_blocked(
        S.reshape(K * 6, K * 6), rhs.reshape(K * 6), bs=6).reshape(K, 6)
    dx_cam = dx_cam * free[:, None]

    # back-substitute: dx_p = Hpp_inv (bp - C^T dx_cam)
    s = jnp.einsum("pkab,ka->pb", C, dx_cam, precision=_HI)
    dx_pt = jnp.stack(
        [jnp.sum(Hpp_inv[:, b, :] * (bp - s), axis=-1) for b in range(3)],
        axis=-1)
    dx_pt = dx_pt * prob.pt_valid.astype(jnp.float32)[:, None]
    return dx_cam, dx_pt, cost


def bundle_adjust_grid(prob: GridBAProblem, cam_model: str, cam_params,
                       iterations: int = 10, lam0: float = 1e-5,
                       chi2_th: float = robust.CHI2_MONO,
                       use_robust: bool = True,
                       stereo_bf: float = 0.0):
    """LM loop with branch-free accept/reject over the grid problem.

    Same contract as ba.bundle_adjust restricted to window problems (no
    GNSS priors — callers with priors use the COO path)."""

    def step(carry, _):
        R, t, X, lam, cost = carry
        dx_cam, dx_pt, cur_cost = _grid_step(
            prob, R, t, X, lam, cam_model, cam_params, chi2_th, use_robust,
            stereo_bf)
        dR, dt = lie.se3_exp(dx_cam)
        R_new, t_new = lie.se3_compose(dR, dt, R, t)
        R_new = lie.normalize_rotation(R_new)
        X_new = X + dx_pt
        new_cost = _grid_cost(prob, R_new, t_new, X_new, cam_model,
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
    return R, t, X, cost

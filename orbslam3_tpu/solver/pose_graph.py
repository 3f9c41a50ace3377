"""Sim(3) pose-graph optimization (essential graph).

Parity target: reference Optimizer::OptimizeEssentialGraph
(src/Optimizer.cc:1848-2179) — 7-dof Sim3 vertices S_iw (world -> KF),
edges with relative Sim3 measurements from loop closures, the spanning
tree and strong covisibility links; identity information; after the
solve, map points are transported by their reference KF's correction
(done by the loop-closing pipeline, not here).

Design: vertices batched (K, 7-dof as R/t/s); residual per edge uses
the component-wise chart r = [Log(R_err), t_err, log(s_err)] of
E = S_meas^-1 S_i S_j^-1 (zero iff the relative pose matches); LM with
forward-mode AD over the stacked local deltas; one dense solve per
iteration (7K x 7K — trivial for K <= 512).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie

_HI = jax.lax.Precision.HIGHEST

# 4-DoF inertial mode: yaw (world-z right perturbation) + translation;
# roll/pitch and scale locked (reference VertexPose4DoF/Edge4DoF)
DOF4_MASK = (0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0)


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray  # (K,3,3) S_iw rotation
    t: jnp.ndarray  # (K,3)
    s: jnp.ndarray  # (K,)
    cost: jnp.ndarray


def _sim3_apply_delta(R, t, s, d):
    """7-dof local update: [dphi(3), dt(3), dsigma(1)]."""
    R2 = jnp.matmul(R, lie.exp_so3(d[..., 0:3]), precision=_HI)
    t2 = t + d[..., 3:6]
    s2 = s * jnp.exp(d[..., 6])
    return R2, t2, s2


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r of E = S_m^-1 (S_i S_j^-1); S x = s R x + t."""
    # S_ij = S_i ∘ S_j^-1
    Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(Rj, tj, sj)
    Rij, tij, sij = lie.sim3_compose(Ri, ti, si, Rj_inv, tj_inv, sj_inv)
    # E = S_m^-1 ∘ S_ij
    Rm_i, tm_i, sm_i = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rm_i, tm_i, sm_i, Rij, tij, sij)
    return jnp.concatenate([lie.log_so3(Re), te,
                            jnp.log(jnp.maximum(se, 1e-9))[None]])


def optimize_pose_graph(R, t, s, fixed, valid,
                        e_i, e_j, e_R, e_t, e_s, e_valid,
                        e_weight=None,
                        iterations: int = 20,
                        lam0: float = 1e-4,
                        dof_mask=None,
                        solver: str = "auto",
                        cg_iters: int = 48) -> PoseGraphResult:
    """R/t/s: (K,...) Sim3 vertices S_iw; fixed/valid: (K,) masks;
    e_*: (E,...) edges with measurements S_ij = S_i S_j^-1;
    e_weight: optional (E,) sqrt-information scalars (loop edges are
    typically weighted above odometry edges);
    dof_mask: optional (7,) per-component delta mask.  The rotation
    delta is a RIGHT (world-frame) perturbation R <- R Exp(dphi), so on
    a gravity-aligned map (gravity along world -z after IMU init)
    DOF4_MASK = [0,0,1, 1,1,1, 0] yields the reference's 4-DoF
    inertial essential graph (yaw + translation, scale and gravity
    locked — VertexPose4DoF/Edge4DoF, include/G2oTypes.h:155,816 and
    Optimizer::OptimizeEssentialGraph4DoF): a Sim3 graph would rescale
    a metric map and tilt gravity."""
    K = R.shape[0]
    E = e_i.shape[0]
    free = (~fixed) & valid
    if e_weight is None:
        e_weight = jnp.ones(E, jnp.float32)
    if dof_mask is None:
        dof_mask = jnp.ones(7, jnp.float32)
    # per-component free mask (K,7): vertex gating x DoF gating
    free_c = free[:, None].astype(jnp.float32) * \
        jnp.asarray(dof_mask, jnp.float32)[None, :]

    if solver == "auto":
        # dense (7K)^2 assembly is fine to a few hundred vertices and
        # has the longest test history; pod-scale maps (K >= 512) go
        # matrix-free: per-edge analytic Jacobian blocks + CG with a
        # block-Jacobi preconditioner — no (7K, 7K) materialization
        solver = "dense" if K < 512 else "cg"

    x0 = jnp.zeros(K * 7, jnp.float32)
    ii = jnp.maximum(e_i, 0)
    jj = jnp.maximum(e_j, 0)

    def _edge_blocks(Rc, tc, sc):
        """Per-edge residuals and (7,7) Jacobian blocks wrt the two
        incident vertex deltas (vmapped jacfwd over a 14-dim input —
        E x 14 work instead of the dense K*7-dim jacfwd)."""
        def one(k):
            i, j = ii[k], jj[k]

            def res_k(d):
                di = d[0:7] * free_c[i]
                dj = d[7:14] * free_c[j]
                Ri2 = jnp.matmul(Rc[i], lie.exp_so3(di[0:3]),
                                 precision=_HI)
                Rj2 = jnp.matmul(Rc[j], lie.exp_so3(dj[0:3]),
                                 precision=_HI)
                r = _edge_residual(
                    Ri2, tc[i] + di[3:6], sc[i] * jnp.exp(di[6]),
                    Rj2, tc[j] + dj[3:6], sc[j] * jnp.exp(dj[6]),
                    e_R[k], e_t[k], e_s[k]) * e_weight[k]
                return jnp.where(e_valid[k], r, jnp.zeros(7))

            z = jnp.zeros(14)
            r0 = res_k(z)
            Jk = jax.jacfwd(res_k)(z)          # (7, 14)
            return r0, Jk[:, 0:7], Jk[:, 7:14]

        return jax.vmap(one)(jnp.arange(E))

    def _solve_cg(Rc, tc, sc, lam):
        r_e, Ji, Jj = _edge_blocks(Rc, tc, sc)          # (E,7),(E,7,7)x2
        # gradient: g = -J^T r scattered per incident vertex
        gi = -jnp.einsum("eab,ea->eb", Ji, r_e, precision=_HI)
        gj = -jnp.einsum("eab,ea->eb", Jj, r_e, precision=_HI)
        g = jnp.zeros((K, 7)).at[ii].add(gi).at[jj].add(gj)
        # block-diagonal of H for the preconditioner
        Hii = jnp.einsum("eab,eac->ebc", Ji, Ji, precision=_HI)
        Hjj = jnp.einsum("eab,eac->ebc", Jj, Jj, precision=_HI)
        diag_pin = 1.0 - free_c
        Hd = jnp.zeros((K, 7, 7)).at[ii].add(Hii).at[jj].add(Hjj)
        Hd = Hd + jax.vmap(jnp.diag)(diag_pin + lam)
        Hd_inv = jnp.linalg.inv(Hd + 1e-8 * jnp.eye(7))

        def matvec(x):                                   # x: (K, 7)
            yi = jnp.einsum("eab,eb->ea", Ji, x[ii], precision=_HI) + \
                jnp.einsum("eab,eb->ea", Jj, x[jj], precision=_HI)
            out = jnp.zeros((K, 7)).at[ii].add(
                jnp.einsum("eab,ea->eb", Ji, yi, precision=_HI)).at[jj].add(
                jnp.einsum("eab,ea->eb", Jj, yi, precision=_HI))
            return out + x * (diag_pin + lam)

        x = jnp.zeros((K, 7))
        r = g
        z = jnp.einsum("kab,kb->ka", Hd_inv, r, precision=_HI)
        p = z

        def cg_step(carry, _):
            x, r, z, p = carry
            Ap = matvec(p)
            rz = jnp.sum(r * z)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
            x2 = x + alpha * p
            r2 = r - alpha * Ap
            z2 = jnp.einsum("kab,kb->ka", Hd_inv, r2, precision=_HI)
            beta = jnp.sum(r2 * z2) / \
                jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            return (x2, r2, z2, z2 + beta * p), None

        (dx, _, _, _), _ = jax.lax.scan(cg_step, (x, r, z, p), None,
                                        length=cg_iters)
        return dx.reshape(-1)

    def step(carry, _):
        Rc, tc, sc, lam, best = carry

        def res(dx):
            d = dx.reshape(K, 7) * free_c
            R2, t2, s2 = _sim3_apply_delta(Rc, tc, sc, d)

            def one(k):
                i, j = e_i[k], e_j[k]
                r = _edge_residual(R2[i], t2[i], s2[i],
                                   R2[j], t2[j], s2[j],
                                   e_R[k], e_t[k], e_s[k]) * e_weight[k]
                return jnp.where(e_valid[k], r, jnp.zeros(7))

            return jax.vmap(one)(jnp.arange(E)).reshape(-1)

        if solver == "cg":
            dx = _solve_cg(Rc, tc, sc, lam)
        else:
            r0 = res(x0)
            J = jax.jacfwd(res)(x0)
            H = jnp.matmul(J.T, J, precision=_HI)
            g = -jnp.matmul(J.T, r0, precision=_HI)
            # pin fixed vertices AND masked-out DoF components
            diag_pin = (1.0 - free_c).reshape(-1)
            H = H + jnp.diag(diag_pin) + lam * jnp.eye(K * 7)
            dx = jnp.linalg.solve(H, g)
        R2, t2, s2 = _sim3_apply_delta(
            Rc, tc, sc, dx.reshape(K, 7) * free_c)
        R2 = lie.normalize_rotation(R2)

        def res_at(Rn, tn, sn):
            def one(k):
                i, j = e_i[k], e_j[k]
                r = _edge_residual(Rn[i], tn[i], sn[i], Rn[j], tn[j], sn[j],
                                   e_R[k], e_t[k], e_s[k]) * e_weight[k]
                return jnp.where(e_valid[k], r, jnp.zeros(7))
            return jax.vmap(one)(jnp.arange(E)).reshape(-1)

        c_old = jnp.sum(res_at(Rc, tc, sc) ** 2)
        c_upd = jnp.sum(res_at(R2, t2, s2) ** 2)
        ok = c_upd < c_old
        Rc = jnp.where(ok, R2, Rc)
        tc = jnp.where(ok, t2, tc)
        sc = jnp.where(ok, s2, sc)
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 5.0), 1e-9, 1e9)
        return (Rc, tc, sc, lam, jnp.minimum(c_upd, c_old)), None

    (Rf, tf, sf, _, cost), _ = jax.lax.scan(
        step, (R, t, s, jnp.asarray(lam0, jnp.float32),
               jnp.asarray(jnp.inf, jnp.float32)), None, length=iterations)
    return PoseGraphResult(R=Rf, t=tf, s=sf, cost=cost)

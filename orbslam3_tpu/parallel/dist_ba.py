"""Distributed Schur-complement bundle adjustment over a device mesh.

This is the build's "model parallelism" (SURVEY §2.11, §5.7): map points
and their observations are sharded across devices; each shard marginalizes
its own points (embarrassingly parallel) and the reduced camera system is
solved matrix-free by PCG whose K-sized contractions are `psum`s over the
device interconnect — the same `solver.ba._solve_schur` code path as
single-device, with `reduce=psum`.  The reference's equivalent is a
single-threaded g2o sparse solve (src/Optimizer.cc:74-85) — there is no
distribution to port; this is the engine's own design.

Sharding invariant: observations must be partitioned so that all
observations of a point live on that point's shard (`partition_problem`
does this host-side once per solve).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import lie
from ..solver import ba as ba_mod
from ..solver.ba import BAProblem

_HI = jax.lax.Precision.HIGHEST


def partition_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Repack points + observations so shard s owns points
    [s*P/n, (s+1)*P/n) and all of their observations (padded per shard).

    Host-side, runs once per solve; keeps capacities static.
    """
    P_cap = prob.X.shape[0]
    O_cap = prob.obs_cam.shape[0]
    assert P_cap % n_shards == 0, "point capacity must divide shard count"
    assert O_cap % n_shards == 0, "obs capacity must divide shard count"
    pts_per = P_cap // n_shards
    obs_per = O_cap // n_shards

    # point shard of each observation
    shard_of_obs = jnp.clip(prob.obs_pt // pts_per, 0, n_shards - 1)
    # stable sort obs by (shard, invalid-last)
    key = shard_of_obs * 2 + (~prob.obs_valid).astype(jnp.int32)
    order = jnp.argsort(key * O_cap + jnp.arange(O_cap))
    # count per shard; if any shard overflows obs_per we drop the excess
    # (reported via obs_valid)
    sh = shard_of_obs[order]
    pos_in_shard = jnp.arange(O_cap) - jax.lax.cummax(
        jnp.where(jnp.concatenate([jnp.array([True]), sh[1:] != sh[:-1]]),
                  jnp.arange(O_cap), 0))
    # overflow rows go out of range and are dropped (clamping them onto
    # the shard's last slot let them overwrite a kept observation there)
    dst = jnp.where(pos_in_shard < obs_per, sh * obs_per + pos_in_shard,
                    O_cap)

    def scatter(arr, fill):
        out = jnp.full((O_cap,) + arr.shape[1:], fill, arr.dtype)
        return out.at[dst].set(arr[order], mode="drop")

    out = prob._replace(
        obs_cam=scatter(prob.obs_cam, 0),
        obs_pt=scatter(prob.obs_pt, 0),
        obs_uv=scatter(prob.obs_uv, 0.0),
        obs_inv_sigma2=scatter(prob.obs_inv_sigma2, 1.0),
        obs_valid=scatter(prob.obs_valid, False))
    if prob.obs_ur is not None:
        out = out._replace(obs_ur=scatter(prob.obs_ur, -1.0))
    return out


def _dense_reduced_local(Hcc, bc, Hpp, bp, Cobs, obs_cam, lo_pt, lam,
                         cam_fixed, pt_valid):
    """Shard-LOCAL pieces of the dense reduced camera system.

    Returns (S_off_l (K,6,K,6), rv_l (K,6)) where the GLOBAL system is
      S = blockdiag(Hcc + lam I) - psum(S_off_l)
      rhs = (psum(bc_l) - psum(rv_l)) * free
    S_off is assembled without the (K, P, 6, 3) coupling tensor via the
    Cholesky-split scatter (G G^T as one matmul — same trick as
    ba._solve_schur_dense, here over the shard's own point block)."""
    P_l = Hpp.shape[0]
    K = Hcc.shape[0]
    Hpp_d = Hpp + lam * jnp.eye(3)[None]
    pt_on = pt_valid.astype(jnp.float32)[:, None, None]
    Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
    Hpp_inv = ba_mod._spd_inv3(Hpp_d)
    L = ba_mod._chol3(Hpp_inv)
    U = jnp.einsum("nij,njl->nil", Cobs, L[lo_pt], precision=_HI)
    G = jnp.zeros((K, P_l, 6, 3)).at[obs_cam, lo_pt].add(U)
    Gr = G.transpose(0, 2, 1, 3).reshape(K * 6, P_l * 3)
    S_off_l = jnp.dot(Gr, Gr.T, precision=_HI).reshape(K, 6, K, 6)
    CW = jnp.einsum("nij,njl->nil", Cobs, Hpp_inv[lo_pt], precision=_HI)
    rv = jnp.einsum("nil,nl->ni", CW, bp[lo_pt], precision=_HI)
    rv_l = jnp.zeros((K, 6)).at[obs_cam].add(rv)
    return S_off_l, rv_l, Hpp_inv


def _dense_pcg(S, rhs, free, pcg_iters: int):
    """Replicated PCG on the dense reduced system (K,6,K,6) with the
    exact block-Jacobi preconditioner — all local, zero collectives."""
    K = rhs.shape[0]
    D = S[jnp.arange(K), :, jnp.arange(K), :]
    D = D + jnp.eye(6)[None] * 1e-8
    D_inv = jnp.linalg.inv(D)

    def mv(x):
        y = jnp.einsum("kilj,lj->ki", S, x, precision=_HI)
        return y * free[:, None] + x * (1 - free)[:, None]

    def precond(r):
        return jnp.einsum("kij,kj->ki", D_inv, r, precision=_HI)

    x0 = jnp.zeros((K, 6))
    z0 = precond(rhs)

    def pcg_step(carry, _):
        x, r, z, p = carry
        Ap = mv(p)
        rz = jnp.sum(r * z)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        beta = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return (x2, r2, z2, z2 + beta * p), None

    (dx, _, _, _), _ = jax.lax.scan(pcg_step, (x0, rhs, z0, z0), None,
                                    length=pcg_iters)
    return dx * free[:, None]


def dist_bundle_adjust(prob: BAProblem, mesh: Mesh, axis: str = "shard",
                       cam_model: str = "pinhole", cam_params=None,
                       iterations: int = 5, lam0: float = 1e-4,
                       chi2_th: float = 5.991, use_robust: bool = True,
                       pcg_iters: int = 32, comm: str = "matvec"):
    """Distributed LM: points+observations sharded over `axis`.

    `prob` must already be partitioned with `partition_problem(n_shards)`.
    Returns (R, t, X, cost) with the same shapes as the input problem.

    comm modes (the per-matvec scheme issues ~35 collectives per LM
    iteration, a latency floor wherever a collective is slow):
      * "dense"    — communication-avoiding: each shard
        assembles its dense reduced-system contribution (G G^T over its
        own point block), ONE batched psum per LM iteration ships
        {S_off, Hcc, bc, rv, cost} together, and the (6K)^2 reduced
        solve runs replicated with a local PCG.  2 collectives per LM
        iteration total (the assembly psum + the accept-test cost psum).
        Right while the camera count keeps (6K)^2 comfortably in device
        memory (K <= ~1024: 151 MB f32).
      * "camshard" — keyframe-block-sharded reduced system (SURVEY
        §2.11 north star; the K >> 1k configuration): every
        device owns K/n camera rows of S/rhs/preconditioner, PCG state
        is sharded, and each matvec costs one small all_gather(x) +
        psum; camera memory AND reduced-solve flops scale 1/n.
      * "matvec"   — psum inside every PCG matvec.  DEFAULT: right for
        in-process meshes over a fast interconnect (NVLink) where a psum
        costs microseconds; cross-process callers should pass "dense".
    """
    n_shards = mesh.shape[axis]
    P_cap = prob.X.shape[0]
    pts_per = P_cap // n_shards
    K = prob.R.shape[0]
    assert K % n_shards == 0 or comm != "camshard", \
        "camshard needs cameras divisible by shard count"

    pspec_pt = P(axis)          # leading dim sharded
    pspec_rep = P()

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(pspec_rep, pspec_rep, pspec_pt, pspec_pt, pspec_pt,
                  pspec_pt, pspec_pt, pspec_pt, pspec_pt,
                  pspec_rep, pspec_rep, pspec_rep),
        out_specs=(pspec_rep, pspec_rep, pspec_pt, pspec_rep),
        check_vma=False)
    def lm_loop(R0, t0, X0, pt_valid, obs_cam, obs_pt, obs_uv, obs_is2,
                obs_valid, cam_fixed, cam_valid, lam_init):
        my = jax.lax.axis_index(axis)
        pt_base = my * pts_per
        # shard-local problem: obs_pt rebased into the local point block
        lo_pt = jnp.clip(obs_pt - pt_base, 0, X0.shape[0] - 1)
        lo_valid = obs_valid & (obs_pt >= pt_base) & \
            (obs_pt < pt_base + X0.shape[0])
        shard_prob = BAProblem(
            R=R0, t=t0, cam_fixed=cam_fixed, cam_valid=cam_valid,
            X=X0, pt_valid=pt_valid,
            obs_cam=obs_cam, obs_pt=lo_pt, obs_uv=obs_uv,
            obs_inv_sigma2=obs_is2, obs_valid=lo_valid)
        free = (~cam_fixed).astype(jnp.float32)

        def reduce(v):
            return jax.lax.psum(v, axis)

        def solve_dense(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam):
            """ONE batched psum ships every global quantity of this
            iteration's normal equations; everything after is local."""
            S_off_l, rv_l, Hpp_inv = _dense_reduced_local(
                Hcc_l, bc_l, Hpp, bp, Cobs, obs_cam, lo_pt, lam,
                cam_fixed, pt_valid)
            flat = jnp.concatenate([
                S_off_l.reshape(-1), Hcc_l.reshape(-1), bc_l.reshape(-1),
                rv_l.reshape(-1), cost_l.reshape(1)])
            flat = reduce(flat)
            nS = K * 6 * K * 6
            nH = K * 36
            S_off = flat[:nS].reshape(K, 6, K, 6)
            Hcc = flat[nS:nS + nH].reshape(K, 6, 6)
            bc = flat[nS + nH:nS + nH + K * 6].reshape(K, 6)
            rv = flat[nS + nH + K * 6:nS + nH + 2 * K * 6].reshape(K, 6)
            cur_cost = flat[-1]
            Hcc_d = Hcc + lam * jnp.eye(6)[None]
            S = -S_off
            S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(Hcc_d)
            ff = free[:, None, None, None] * free[None, None, :, None]
            S = S * ff
            S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(
                jnp.eye(6)[None] * (1 - free)[:, None, None])
            rhs = (bc - rv) * free[:, None]
            dx_cam = _dense_pcg(S, rhs, free, pcg_iters)
            # local point back-substitution over the shard's block
            u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[obs_cam],
                           precision=_HI)
            s = jnp.zeros((Hpp.shape[0], 3)).at[lo_pt].add(u)
            dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - s,
                               precision=_HI)
            dx_pt = dx_pt * pt_valid.astype(jnp.float32)[:, None]
            return dx_cam, dx_pt, cur_cost

        def solve_camshard(Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam):
            """Keyframe-block-sharded reduced solve: this shard owns
            camera rows [my*Kl, (my+1)*Kl).  PCG state (x, r, z, p) is
            (Kl, 6); each matvec all_gathers the K-vector (K*24 bytes)
            and psums the scattered result back to rows."""
            Kl = K // n_shards
            cam_base = my * Kl
            rows = cam_base + jnp.arange(Kl)
            # global Hcc/bc/cost in one batched psum (diag blocks are
            # needed globally only for the matvec's diagonal term, which
            # we fold into the scattered part below, so reduce-keep rows)
            flat = reduce(jnp.concatenate([
                Hcc_l.reshape(-1), bc_l.reshape(-1), cost_l.reshape(1)]))
            Hcc = flat[:K * 36].reshape(K, 6, 6)
            bc = flat[K * 36:K * 36 + K * 6].reshape(K, 6)
            cur_cost = flat[-1]
            Hcc_d = Hcc + lam * jnp.eye(6)[None]
            P_l = Hpp.shape[0]
            Hpp_d = Hpp + lam * jnp.eye(3)[None]
            pt_on = pt_valid.astype(jnp.float32)[:, None, None]
            Hpp_d = Hpp_d * pt_on + jnp.eye(3)[None] * (1 - pt_on)
            Hpp_inv = ba_mod._spd_inv3(Hpp_d)
            CW = jnp.einsum("nij,njl->nil", Cobs, Hpp_inv[lo_pt],
                            precision=_HI)
            free_l = free[rows]

            def S_matvec_rows(xg):
                """Full x (K,6) in, THIS SHARD'S rows of S x out (via a
                psum of the scattered coupling term)."""
                xm = xg * free[:, None]
                u = jnp.einsum("nij,ni->nj", Cobs, xm[obs_cam],
                               precision=_HI)
                s = jnp.zeros((P_l, 3)).at[lo_pt].add(u)
                v = jnp.einsum("nil,nl->ni", CW, s[lo_pt], precision=_HI)
                coup = reduce(jnp.zeros((K, 6)).at[obs_cam].add(v))
                y = jnp.einsum("kij,kj->ki", Hcc_d[rows], xm[rows],
                               precision=_HI) - coup[rows]
                return y * free_l[:, None] + xg[rows] * \
                    (1 - free_l)[:, None]

            # rhs rows + exact block-Jacobi rows
            rv = jnp.einsum("nil,nl->ni", CW, bp[lo_pt], precision=_HI)
            Dn = jnp.einsum("nil,nml->nim", CW, Cobs, precision=_HI)
            packed = reduce(jnp.concatenate([
                jnp.zeros((K, 6)).at[obs_cam].add(rv).reshape(-1),
                jnp.zeros((K, 6, 6)).at[obs_cam].add(Dn).reshape(-1)]))
            rv_g = packed[:K * 6].reshape(K, 6)
            D_off = packed[K * 6:].reshape(K, 6, 6)
            rhs_l = (bc[rows] - rv_g[rows]) * free_l[:, None]
            D = Hcc_d[rows] - D_off[rows]
            D = D * free_l[:, None, None] + \
                jnp.eye(6)[None] * (1 - free_l)[:, None, None]
            D_inv = jnp.linalg.inv(D + jnp.eye(6)[None] * 1e-8)

            def precond(r):
                return jnp.einsum("kij,kj->ki", D_inv, r, precision=_HI)

            def gather_rows(x_l):
                return jax.lax.all_gather(x_l, axis).reshape(K, 6)

            x0 = jnp.zeros((Kl, 6))
            z0 = precond(rhs_l)

            def pcg_step(carry, _):
                x, r, z, p = carry
                Ap = S_matvec_rows(gather_rows(p))
                # global dots: one scalar-pair psum
                dots = reduce(jnp.stack([jnp.sum(r * z),
                                         jnp.sum(p * Ap)]))
                rz, denom = dots[0], dots[1]
                alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20,
                                       denom)
                x2 = x + alpha * p
                r2 = r - alpha * Ap
                z2 = precond(r2)
                rz2 = reduce(jnp.sum(r2 * z2))
                beta = rz2 / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
                return (x2, r2, z2, z2 + beta * p), None

            (dx_l, _, _, _), _ = jax.lax.scan(
                pcg_step, (x0, rhs_l, z0, z0), None, length=pcg_iters)
            dx_cam = gather_rows(dx_l * free_l[:, None]) * free[:, None]
            u = jnp.einsum("nij,ni->nj", Cobs, dx_cam[obs_cam],
                           precision=_HI)
            s = jnp.zeros((P_l, 3)).at[lo_pt].add(u)
            dx_pt = jnp.einsum("pij,pj->pi", Hpp_inv, bp - s,
                               precision=_HI)
            dx_pt = dx_pt * pt_valid.astype(jnp.float32)[:, None]
            return dx_cam, dx_pt, cur_cost

        def step(carry, _):
            R, t, X, lam, best_cost = carry
            Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, _, _ = \
                ba_mod._build_normal_eq(shard_prob, R, t, X, cam_model,
                                        cam_params, chi2_th, use_robust)
            if comm == "dense":
                dx_cam, dx_pt, cur_cost = solve_dense(
                    Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam)
            elif comm == "camshard":
                dx_cam, dx_pt, cur_cost = solve_camshard(
                    Hcc_l, bc_l, Hpp, bp, Cobs, cost_l, lam)
            else:
                Hcc = reduce(Hcc_l)
                bc = reduce(bc_l)
                cur_cost = reduce(cost_l)
                dx_cam, dx_pt = ba_mod._solve_schur(
                    Hcc, bc, Hpp, bp, Cobs, obs_cam, lo_pt, lam,
                    cam_fixed, pt_valid, pcg_iters=pcg_iters,
                    reduce=reduce)

            dR, dt = lie.se3_exp(dx_cam)
            R_new, t_new = lie.se3_compose(dR, dt, R, t)
            R_new = lie.normalize_rotation(R_new)
            X_new = X + dx_pt
            new_cost = reduce(ba_mod._cost_only(
                shard_prob, R_new, t_new, X_new, cam_model, cam_params,
                chi2_th, use_robust))
            accept = new_cost < cur_cost
            R = jnp.where(accept, R_new, R)
            t = jnp.where(accept, t_new, t)
            X = jnp.where(accept, X_new, X)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0),
                           1e-9, 1e6)
            return (R, t, X, lam, jnp.minimum(new_cost, cur_cost)), None

        init = (R0, t0, X0, lam_init, jnp.asarray(jnp.inf, jnp.float32))
        (R, t, X, _, cost), _ = jax.lax.scan(step, init, None,
                                             length=iterations)
        return R, t, X, cost

    lam = jnp.asarray(lam0, jnp.float32)
    return lm_loop(prob.R, prob.t, prob.X, prob.pt_valid,
                   prob.obs_cam, prob.obs_pt, prob.obs_uv,
                   prob.obs_inv_sigma2, prob.obs_valid,
                   prob.cam_fixed, prob.cam_valid, lam)

"""Inertial factors and visual-inertial optimizers.

Parity targets (reference src/Optimizer.cc, include/G2oTypes.h):
  * EdgeInertial (G2oTypes.h:495): 9-dof preintegration residual between
    consecutive keyframes [r_R, r_v, r_p]:
       r_R = Log( dR(b)^T R1^T R2 )
       r_v = R1^T (v2 - v1 - g dt)        - dV(b)
       r_p = R1^T (p2 - p1 - v1 dt - 0.5 g dt^2) - dP(b)
    information = inverse of the preintegration covariance (9x9 block).
  * EdgeGyroRW / EdgeAccRW (G2oTypes.h:634,670): bias random walk between
    KFs, information from covariance blocks 9-11 / 12-14.
  * InertialOptimization (Optimizer.cc:2964): poses fixed; optimize
    velocities, one shared gyro+acc bias, gravity direction (2-dof) and
    log-scale; priors on biases; 200 iterations.
  * FullInertialBA (Optimizer.cc:371): joint visual + inertial BA.

Design: residuals are pure functions; Jacobians via forward-mode AD
(jax.jacfwd) — identical structure to the hand-derived g2o Jacobians but
generated by the tracer and fused by XLA.  Small dense LM solves (state
dim <= a few hundred for init; Schur for the VI-BA).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import imu as imu_ops
from ..ops import lie

_HI = jax.lax.Precision.HIGHEST
GRAVITY_MAG = 9.81


class PreintFactor(NamedTuple):
    """Preintegration between consecutive KFs (i -> i+1), SoA batched."""
    dR: jnp.ndarray     # (F,3,3)
    dV: jnp.ndarray     # (F,3)
    dP: jnp.ndarray     # (F,3)
    JRg: jnp.ndarray    # (F,3,3)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    C: jnp.ndarray      # (F,15,15)
    dT: jnp.ndarray     # (F,)
    b0: jnp.ndarray     # (F,6) linearization bias
    kf_i: jnp.ndarray   # (F,) source KF index
    kf_j: jnp.ndarray   # (F,) target KF index
    valid: jnp.ndarray  # (F,)


def stack_preints(preints: list, kf_i: list, kf_j: list,
                  capacity: int) -> PreintFactor:
    """Stack host-collected Preintegrated states into a padded factor SoA."""
    import numpy as np
    F = capacity
    z3 = np.zeros((F, 3, 3), np.float32)

    def pad(getter, shape):
        out = np.zeros((F,) + shape, np.float32)
        for k, st in enumerate(preints[:F]):
            out[k] = np.asarray(getter(st))
        return jnp.asarray(out)

    n = min(len(preints), F)
    return PreintFactor(
        dR=pad(lambda s: s.dR, (3, 3)),
        dV=pad(lambda s: s.dV, (3,)),
        dP=pad(lambda s: s.dP, (3,)),
        JRg=pad(lambda s: s.JRg, (3, 3)),
        JVg=pad(lambda s: s.JVg, (3, 3)),
        JVa=pad(lambda s: s.JVa, (3, 3)),
        JPg=pad(lambda s: s.JPg, (3, 3)),
        JPa=pad(lambda s: s.JPa, (3, 3)),
        C=pad(lambda s: s.C, (15, 15)),
        dT=pad(lambda s: s.dT, ()),
        b0=pad(lambda s: s.b, (6,)),
        kf_i=jnp.asarray(np.pad(np.asarray(kf_i[:F], np.int32),
                                (0, F - n))),
        kf_j=jnp.asarray(np.pad(np.asarray(kf_j[:F], np.int32),
                                (0, F - n))),
        valid=jnp.asarray(np.arange(F) < n))


@functools.lru_cache(maxsize=None)
def _device_stacker(capacity: int):
    """One jitted stacking program per capacity.  The preint list is
    padded to EXACTLY `capacity` entries by the caller, so the program
    signature is stable — without the padding, every new list length was
    a fresh trace and compile."""

    @jax.jit
    def stk(sel, ki, kj, n):
        f = jax.tree.map(lambda *xs: jnp.stack(xs), *sel)
        F = capacity
        return PreintFactor(
            dR=f.dR, dV=f.dV, dP=f.dP, JRg=f.JRg, JVg=f.JVg, JVa=f.JVa,
            JPg=f.JPg, JPa=f.JPa, C=f.C, dT=f.dT, b0=f.b,
            kf_i=ki, kf_j=kj, valid=jnp.arange(F) < n)

    return stk


def stack_preints_device(preints: list, kf_i: list, kf_j: list,
                         capacity: int) -> PreintFactor:
    """Device-side factor stack: ONE jitted dispatch, never `np.asarray`
    on a device array.  The numpy `stack_preints` pulls every field of
    every NEW preint to the host (~11 device->host syncs per keyframe);
    here the factor stays on device end to end."""
    import numpy as np
    F = capacity
    n = min(len(preints), F)
    if n == 0:
        sel = [imu_ops.init_preintegrated()] * F
    else:
        # pad by repeating the first entry: constant operand count keeps
        # the jitted stacker's signature stable; `valid` masks the pads
        sel = list(preints[:n]) + [preints[0]] * (F - n)
    ki = jnp.asarray(np.pad(np.asarray(kf_i[:F], np.int32), (0, F - n)))
    kj = jnp.asarray(np.pad(np.asarray(kf_j[:F], np.int32), (0, F - n)))
    return _device_stacker(F)(sel, ki, kj, jnp.asarray(n, jnp.int32))


def factor_from_preint(pre, kf_i=0, kf_j=1) -> PreintFactor:
    """Capacity-1 PreintFactor from a single (traced) Preintegrated —
    usable INSIDE a jit program (no host staging at all).  Used by the
    fused inertial tracked-frame program to build the last-KF /
    last-frame factor from an in-program preintegration."""
    return PreintFactor(
        dR=pre.dR[None], dV=pre.dV[None], dP=pre.dP[None],
        JRg=pre.JRg[None], JVg=pre.JVg[None], JVa=pre.JVa[None],
        JPg=pre.JPg[None], JPa=pre.JPa[None], C=pre.C[None],
        dT=pre.dT[None], b0=pre.b[None],
        kf_i=jnp.full((1,), kf_i, jnp.int32),
        kf_j=jnp.full((1,), kf_j, jnp.int32),
        valid=jnp.ones((1,), bool))


def gravity_from_dir(gdir: jnp.ndarray) -> jnp.ndarray:
    """2-dof gravity direction -> world gravity vector (reference
    VertexGDir: Rwg * [0,0,-G], Rwg = Exp([gx, gy, 0]))."""
    Rwg = lie.exp_so3(jnp.concatenate([gdir, jnp.zeros(1)]))
    return Rwg @ jnp.array([0.0, 0.0, -GRAVITY_MAG])


def inertial_residual(f: PreintFactor, k,
                      Rwb1, p1, v1, Rwb2, p2, v2, bias, g):
    """9-dof residual of factor k at the given states (bias-corrected
    deltas via first-order Jacobians — reference EdgeInertial::computeError)."""
    db = bias - f.b0[k]
    dbg, dba = db[:3], db[3:]
    dR = jnp.matmul(f.dR[k], lie.exp_so3(f.JRg[k] @ dbg), precision=_HI)
    dV = f.dV[k] + f.JVg[k] @ dbg + f.JVa[k] @ dba
    dP = f.dP[k] + f.JPg[k] @ dbg + f.JPa[k] @ dba
    dt = f.dT[k]
    r_R = lie.log_so3(jnp.matmul(dR.T, jnp.matmul(Rwb1.T, Rwb2,
                                                  precision=_HI),
                      precision=_HI))
    r_v = Rwb1.T @ (v2 - v1 - g * dt) - dV
    r_p = Rwb1.T @ (p2 - p1 - v1 * dt - 0.5 * g * dt * dt) - dP
    return jnp.concatenate([r_R, r_v, r_p])


def info_from_cov(C9: jnp.ndarray) -> jnp.ndarray:
    """Symmetrized inverse of the 9x9 preintegration covariance block
    (reference EdgeInertial ctor: cholesky-based inverse + symmetrize)."""
    C = 0.5 * (C9 + jnp.swapaxes(C9, -1, -2)) + jnp.eye(9) * 1e-9
    I = jnp.linalg.inv(C)
    return 0.5 * (I + jnp.swapaxes(I, -1, -2))


class InertialInitResult(NamedTuple):
    scale: jnp.ndarray      # ()
    Rwg: jnp.ndarray        # (3,3) gravity rotation
    bias: jnp.ndarray       # (6,) shared [gyro, acc]
    vel: jnp.ndarray        # (K,3) body velocities
    cost: jnp.ndarray


def inertial_only_init(f: PreintFactor, Rwb: jnp.ndarray, pwb: jnp.ndarray,
                       kf_valid: jnp.ndarray,
                       prior_g: float = 1e2, prior_a: float = 1e6,
                       iterations: int = 50,
                       fix_scale: bool = False) -> InertialInitResult:
    """Inertial-only initialization (reference InertialOptimization,
    src/Optimizer.cc:2964): camera poses fixed (up to global scale +
    gravity rotation), solve for velocities, a single shared bias, gravity
    direction and log-scale by LM over the preintegration factors.

    Rwb/pwb: (K,3,3)/(K,3) current (unscaled) body poses.
    """
    K = Rwb.shape[0]
    F = f.kf_i.shape[0]

    def unpack(x):
        vel = x[: 3 * K].reshape(K, 3)
        bias = x[3 * K: 3 * K + 6]
        gdir = x[3 * K + 6: 3 * K + 8]
        log_s = x[3 * K + 8]
        return vel, bias, gdir, log_s

    W = jax.vmap(info_from_cov)(f.C[:, :9, :9])  # (F,9,9)
    # scale residuals by sqrt-information via Cholesky
    L = jnp.linalg.cholesky(W + jnp.eye(9)[None] * 1e-12)

    def residuals(x):
        vel, bias, gdir, log_s = unpack(x)
        s = jnp.exp(log_s) if not fix_scale else 1.0
        g = gravity_from_dir(gdir)

        def one(k):
            i, j = f.kf_i[k], f.kf_j[k]
            r = inertial_residual(
                f, k, Rwb[i], s * pwb[i], vel[i],
                Rwb[j], s * pwb[j], vel[j], bias, g)
            r = jnp.einsum("ab,b->a", L[k], r, precision=_HI)
            return jnp.where(f.valid[k], r, jnp.zeros(9))

        r_in = jax.vmap(one)(jnp.arange(F)).reshape(-1)
        r_prior = jnp.concatenate([
            jnp.sqrt(prior_g) * bias[:3], jnp.sqrt(prior_a) * bias[3:]])
        return jnp.concatenate([r_in, r_prior])

    x0 = jnp.zeros(3 * K + 9, jnp.float32)

    def lm_step(carry, _):
        x, lam, best = carry
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = jnp.matmul(J.T, J, precision=_HI)
        b = -jnp.matmul(J.T, r, precision=_HI)
        dx = jnp.linalg.solve(H + lam * jnp.eye(x.shape[0]), b)
        x_new = x + dx
        c_new = jnp.sum(residuals(x_new) ** 2)
        c_old = jnp.sum(r ** 2)
        ok = c_new < c_old
        x = jnp.where(ok, x_new, x)
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 5.0), 1e-9, 1e9)
        return (x, lam, jnp.minimum(c_new, c_old)), None

    (x, _, cost), _ = jax.lax.scan(
        lm_step, (x0, jnp.asarray(1e-2, jnp.float32),
                  jnp.asarray(jnp.inf, jnp.float32)),
        None, length=iterations)

    vel, bias, gdir, log_s = unpack(x)
    return InertialInitResult(
        scale=jnp.exp(log_s) if not fix_scale else jnp.asarray(1.0),
        Rwg=lie.exp_so3(jnp.concatenate([gdir, jnp.zeros(1)])),
        bias=bias, vel=vel, cost=cost)

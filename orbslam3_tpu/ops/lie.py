"""Lie-group operations: SO(3), SE(3), Sim(3).

Design notes
-----------------------
Rotations are stored as 3x3 matrices (f32): matmul-friendly, trivially
batched, and XLA fuses the small einsums.  All functions broadcast over
arbitrary leading batch dimensions and are safe under `vmap`/`jit`.

Numerical recipes mirror the reference's Sophus/g2o usage
(reference: /root/reference/include/G2oTypes.h:55-71 ExpSO3/LogSO3/
InverseRightJacobianSO3 and /root/reference/src/ImuTypes.cc:86
IntegratedRotation) but are written from scratch with Taylor guards
suitable for f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8
# Tiny 3x3 algebra must not run at reduced matmul precision (bf16/TF32).
_HI = jax.lax.Precision.HIGHEST


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sin_x_over_x(x2: jnp.ndarray) -> jnp.ndarray:
    """sin(x)/x with Taylor fallback, given x^2."""
    x = jnp.sqrt(x2 + _EPS * (x2 < _EPS))
    small = x2 < 1e-8
    return jnp.where(small, 1.0 - x2 / 6.0, jnp.sin(x) / x)


def _one_minus_cos_over_x2(x2: jnp.ndarray) -> jnp.ndarray:
    """(1-cos x)/x^2 with Taylor fallback, given x^2."""
    x = jnp.sqrt(x2 + _EPS * (x2 < _EPS))
    small = x2 < 1e-8
    return jnp.where(small, 0.5 - x2 / 24.0, (1.0 - jnp.cos(x)) / (x2 + _EPS))


def exp_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: so(3) vector (..., 3) -> rotation matrix (..., 3, 3)."""
    x2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + _sin_x_over_x(x2) * W + _one_minus_cos_over_x2(x2) * W2


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> so(3) vector (..., 3).

    Uses the trace formula with a quaternion-style fallback near pi to stay
    finite; accurate to f32 for angles in [0, pi - 1e-3].
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w_unnorm = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    # AD-safe angle: derive sin from |w_unnorm| with the double-where trick
    # (arccos has an infinite derivative at +-1, which poisons jacfwd
    # through residuals that are ~0 at the linearization point).
    s2 = jnp.sum(w_unnorm * w_unnorm, axis=-1)
    small = s2 < 1e-10
    s2_safe = jnp.where(small, 1.0, s2)
    sin_t = jnp.sqrt(s2_safe)
    theta = jnp.arctan2(sin_t, cos_t)
    near_pi = cos_t < jnp.cos(jnp.pi - 1e-3)
    # generic: axis * theta = w_unnorm * theta / sin(theta);
    # small angle: log ~= w_unnorm (linear in R — safe gradients)
    scale = jnp.where(small, 1.0, theta / sin_t)
    w_generic = w_unnorm * scale[..., None]
    # near-pi angle from sin alone (clipped for finite gradients)
    theta = jnp.pi - jnp.arcsin(
        jnp.clip(jnp.sqrt(s2 + 1e-20), 0.0, 1.0 - 1e-7))
    # near pi: axis from diagonal of (R + I)/2 = axis axis^T (1-cos)+...
    #   R + I ~ 2 axis axis^T at theta = pi
    B = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    d = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    k = jnp.argmax(d, axis=-1)
    col = jnp.take_along_axis(B, k[..., None, None].repeat(3, -2), axis=-1)[..., 0]
    axis = col / (jnp.linalg.norm(col, axis=-1, keepdims=True) + _EPS)
    # fix sign using w_unnorm (sin may be ~0 but slightly +/-)
    sgn = jnp.where(jnp.sum(axis * w_unnorm, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    w_pi = axis * sgn * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Right Jacobian Jr(w) of SO(3): d Exp(w+dw) = Exp(w) Exp(Jr dw)."""
    x2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    x = jnp.sqrt(x2 + _EPS * (x2 < _EPS))
    small = x2 < 1e-8
    c1 = jnp.where(small, 0.5 - x2 / 24.0, (1.0 - jnp.cos(x)) / (x2 + _EPS))
    c2 = jnp.where(small, 1.0 / 6.0 - x2 / 120.0,
                   (x - jnp.sin(x)) / (x2 * x + _EPS))
    return I - c1 * W + c2 * W2


def inv_right_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian Jr^{-1}(w)."""
    x2 = jnp.sum(w * w, axis=-1)[..., None, None]
    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HI)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    x = jnp.sqrt(x2 + _EPS * (x2 < _EPS))
    small = x2 < 1e-8
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + x2 / 720.0,
        (1.0 / (x2 + _EPS)) - (1.0 + jnp.cos(x)) / (2.0 * x * jnp.sin(x) + _EPS),
    )
    return I + 0.5 * W + cot_term * W2


def left_jacobian_so3(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian Jl(w) = Jr(-w)."""
    return right_jacobian_so3(-w)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a NEAR-rotation matrix (per g2o's
    NormalizeRotation, reference include/G2oTypes.h).

    Inputs here are always products of exact rotations accumulating f32
    round-off (BA/pose-opt LM updates, IMU preintegration scans), i.e.
    within ~1e-3 of SO(3), so two Newton-Schulz polar steps
    (R <- 1.5 R - 0.5 R R^T R, quadratic convergence for singular values
    in (0, sqrt(3))) reach f32 precision — pure matmuls instead of an
    iterative batched SVD.  For matrices far from SO(3)
    (e.g. a raw DLT estimate) use `normalize_rotation_svd`."""
    for _ in range(2):
        RtR = jnp.einsum("...ji,...jk->...ik", R, R, precision=_HI)
        R = 1.5 * R - 0.5 * jnp.matmul(R, RtR, precision=_HI)
    return R


def normalize_rotation_svd(R: jnp.ndarray) -> jnp.ndarray:
    """Exact projection onto SO(3) via SVD — handles arbitrary (possibly
    reflected/scaled) inputs; an iterative batched SVD."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)[..., None, None]
    D = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    D = D.at[..., 2, 2].multiply(jnp.sign(det[..., 0, 0]))
    return jnp.matmul(jnp.matmul(U, D, precision=_HI), Vt, precision=_HI)


# ---------------------------------------------------------------------------
# SE(3): dict-free representation as a pair (R, t).  Transform convention
# matches the reference: T_cw maps world -> camera, x_c = R x_w + t.
# ---------------------------------------------------------------------------

def se3_exp(xi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """se(3) -> SE(3).  xi = [rho (trans), phi (rot)], shape (..., 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = left_jacobian_so3(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=_HI)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    phi = log_so3(R)
    Vinv = jnp.swapaxes(inv_right_jacobian_so3(phi), -1, -2)  # Jl^-1 = Jr^-1(w)^T
    rho = jnp.einsum("...ij,...j->...i", Vinv, t, precision=_HI)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(R: jnp.ndarray, t: jnp.ndarray):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): applies b first, then a."""
    R = jnp.matmul(Ra, Rb, precision=_HI)
    t = jnp.einsum("...ij,...j->...i", Ra, tb, precision=_HI) + ta
    return R, t


def se3_apply(R, t, x):
    return jnp.einsum("...ij,...j->...i", R, x, precision=_HI) + t


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s); x' = s R x + t.  Used for loop closure, gravity/scale
# re-anchoring (reference src/Map.cc:253) and GNSS georeferencing.
# ---------------------------------------------------------------------------

def sim3_apply(R, t, s, x):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x, precision=_HI) + t


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    R = jnp.matmul(Ra, Rb, precision=_HI)
    t = sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb, precision=_HI) + ta
    return R, t, sa * sb


# ---------------------------------------------------------------------------
# Quaternion helpers (wxyz) for compact storage / checkpointing.
# ---------------------------------------------------------------------------

def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Branch-free (select-based) Shepperd conversion, (...,3,3) -> (...,4) wxyz."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return jnp.stack([w, x, y, z], axis=-1)

    q0 = mk(1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = mk(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = mk(m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    q3 = mk(m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)
    # pick the numerically largest pivot
    vals = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], axis=-1)
    idx = jnp.argmax(vals, axis=-1)[..., None]
    q = jnp.select(
        [idx == 0, idx == 1, idx == 2],
        [q0, q1, q2],
        q3,
    )
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)

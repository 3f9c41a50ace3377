"""Camera models: Pinhole and Kannala-Brandt-8 (fisheye equidistant).

Design: cameras are plain parameter vectors, all functions are
pure, broadcast over leading dims, and differentiable.  Model selection is
a static Python-level switch (one compiled program per model — no runtime
polymorphism, unlike the reference's GeometricCamera virtual interface,
reference include/CameraModels/GeometricCamera.h:36-86).

Parameter layout (f32 vector `params`):
  Pinhole        : [fx, fy, cx, cy]
  KannalaBrandt8 : [fx, fy, cx, cy, k1, k2, k3, k4]

Conventions match the reference: points in camera frame, z forward;
`project` maps 3D camera-frame point -> pixel; `unproject` maps pixel ->
unit-z ray (pinhole) / bearing (KB8).
(reference: src/CameraModels/Pinhole.cpp, src/CameraModels/KannalaBrandt8.cpp)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PINHOLE = "pinhole"
KANNALA_BRANDT8 = "kb8"

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------

def pinhole_project(params: jnp.ndarray, xc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame 3D point (..., 3) -> pixel (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = xc[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    u = fx * xc[..., 0] * inv_z + cx
    v = fy * xc[..., 1] * inv_z + cy
    return jnp.stack([u, v], axis=-1)


def pinhole_unproject(params: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixel (..., 2) -> ray with z=1, shape (..., 3)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def pinhole_project_jac(params: jnp.ndarray, xc: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(xc): (..., 2, 3).  Matches reference Pinhole::projectJac."""
    fx, fy = params[0], params[1]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([fx * inv_z, zero, -fx * x * inv_z2], axis=-1)
    row1 = jnp.stack([zero, fy * inv_z, -fy * y * inv_z2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant polynomial, k1..k4)
#   r(theta) = theta + k1 theta^3 + k2 theta^5 + k3 theta^7 + k4 theta^9
# (reference src/CameraModels/KannalaBrandt8.cpp:176 project, :216 unproject
#  via Newton iteration)
# ---------------------------------------------------------------------------

def _kb8_rtheta(k: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _kb8_drtheta(k: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))


def kb8_project(params: jnp.ndarray, xc: jnp.ndarray) -> jnp.ndarray:
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r2d = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(r2d, z)
    rt = _kb8_rtheta(k, theta)
    scale = rt / jnp.where(r2d < _EPS, _EPS, r2d)
    # at r2d ~ 0 (on-axis), u = cx, v = cy
    scale = jnp.where(r2d < _EPS, 0.0, scale)
    u = fx * x * scale + cx
    v = fy * y * scale + cy
    return jnp.stack([u, v], axis=-1)


def kb8_unproject(params: jnp.ndarray, uv: jnp.ndarray, iters: int = 10) -> jnp.ndarray:
    """Pixel -> unit-norm bearing via fixed-iteration Newton solve of
    r(theta) = r_d (reference uses 10 iterations with 1e-6 early exit;
    we run the fixed 10 — XLA-friendly, same fixed point)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    rd = jnp.sqrt(mx * mx + my * my)
    rd_c = jnp.clip(rd, 0.0, jnp.pi)  # reference clips theta_d to [-pi, pi]
    theta = rd_c

    def body(_, th):
        f = _kb8_rtheta(k, th) - rd_c
        df = _kb8_drtheta(k, th)
        return th - f / jnp.where(jnp.abs(df) < _EPS, _EPS, df)

    theta = jax.lax.fori_loop(0, iters, body, theta)
    scale = jnp.where(rd < _EPS, 1.0, jnp.tan(theta) / jnp.where(rd < _EPS, 1.0, rd))
    # bearing with z=1 then normalized is the reference convention
    # (KannalaBrandt8::unprojectEig returns unitToPixel-normalized ray)
    b = jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)
    return b


def kb8_project_jac(params: jnp.ndarray, xc: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/d(xc) via jacfwd of the analytic projection (2, 3) per point.

    The reference writes this out analytically
    (KannalaBrandt8::projectJac, src/CameraModels/KannalaBrandt8.cpp); under
    XLA, forward-mode AD of the closed form fuses to the same arithmetic.
    """
    flat = xc.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(lambda p: kb8_project(params, p)))(flat)
    return J.reshape(xc.shape[:-1] + (2, 3))


# ---------------------------------------------------------------------------
# Dispatch table
# ---------------------------------------------------------------------------

def project(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project(params, xc)
    if model == KANNALA_BRANDT8:
        return kb8_project(params, xc)
    raise ValueError(f"unknown camera model {model}")


def unproject(model: str, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    if model == KANNALA_BRANDT8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera model {model}")


def project_jac(model: str, params, xc):
    if model == PINHOLE:
        return pinhole_project_jac(params, xc)
    if model == KANNALA_BRANDT8:
        return kb8_project_jac(params, xc)
    raise ValueError(f"unknown camera model {model}")

"""IC-angle (intensity centroid) keypoint orientation.

Behavioral reference: /root/reference/src/cuda/Angle_gpu.cu IC_Angle_kernel —
moments m10 = sum(u * I), m01 = sum(v * I) over a circular patch of radius
HALF_PATCH_SIZE=15 whose per-row half-width is the `umax` table
(src/ORBextractor.cc:128-144); angle = atan2(m01, m10) in degrees [0, 360).

Design: gather a (2r+1)^2 patch per keypoint (vmapped dynamic-slice →
one big gather), apply the circular mask as a weight image, reduce with two
dot products.  ops/describe_kernel.py fuses the same moments into one
Pallas kernel for CUDA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH_SIZE = 15


@functools.lru_cache(maxsize=None)
def _umax_table(half_patch: int = HALF_PATCH_SIZE) -> np.ndarray:
    """Per-row half-width of the circular patch, symmetric like the
    reference (src/ORBextractor.cc:128-144)."""
    umax = np.zeros(half_patch + 2, dtype=np.int32)
    vmax = int(np.floor(half_patch * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half_patch * np.sqrt(2.0) / 2))
    hp2 = half_patch * half_patch
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half_patch + 1]


@functools.lru_cache(maxsize=None)
def _moment_weights(half_patch: int = HALF_PATCH_SIZE):
    """(2r+1, 2r+1) weight images (wu, wv) implementing the circular mask:
    wu[y, x] = u if |u| <= umax[|v|] else 0, and likewise wv."""
    r = half_patch
    umax = _umax_table(half_patch)
    u = np.arange(-r, r + 1)
    v = np.arange(-r, r + 1)
    uu, vv = np.meshgrid(u, v)  # vv rows, uu cols
    inside = np.abs(uu) <= umax[np.abs(vv)]
    wu = (uu * inside).astype(np.float32)
    wv = (vv * inside).astype(np.float32)
    return wu, wv


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Gather (2r+1)^2 patches centered at integer xy (N, 2) -> (N, s, s).
    Centers are clamped so patches stay in-bounds (callers keep keypoints
    inside the border anyway)."""
    h, w = img.shape
    s = 2 * radius + 1
    x0 = jnp.clip(xy[:, 0] - radius, 0, w - s).astype(jnp.int32)
    y0 = jnp.clip(xy[:, 1] - radius, 0, h - s).astype(jnp.int32)

    def slice_one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (s, s))

    return jax.vmap(slice_one)(y0, x0)


def ic_angle_conv(img: jnp.ndarray, xy: jnp.ndarray,
                  half_patch: int = HALF_PATCH_SIZE) -> jnp.ndarray:
    """Dense-moment-map variant (one 31x31 2-channel conv + per-keypoint
    lookup); an alternative formulation kept for comparison."""
    wu, wv = _moment_weights(half_patch)
    k = jnp.stack([jnp.asarray(wu), jnp.asarray(wv)], axis=0)  # (2, s, s)
    x = img[None, None, :, :]
    m = jax.lax.conv_general_dilated(
        x, k[:, None, :, :], (1, 1),
        padding=[(half_patch, half_patch)] * 2)  # (1, 2, H, W)
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), 0, img.shape[1] - 1)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), 0, img.shape[0] - 1)
    m10 = m[0, 0, yi, xi]
    m01 = m[0, 1, yi, xi]
    ang = jnp.arctan2(m01, m10)
    ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
    return ang * (180.0 / jnp.pi)


def ic_angle_from_patches(patches: jnp.ndarray,
                          half_patch: int = HALF_PATCH_SIZE) -> jnp.ndarray:
    """Orientation from pre-extracted (N, 2r+1, 2r+1) patches."""
    wu, wv = _moment_weights(half_patch)
    m10 = jnp.einsum("nij,ij->n", patches, jnp.asarray(wu))
    m01 = jnp.einsum("nij,ij->n", patches, jnp.asarray(wv))
    ang = jnp.arctan2(m01, m10)
    ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
    return ang * (180.0 / jnp.pi)


def ic_angle(img: jnp.ndarray, xy: jnp.ndarray,
             half_patch: int = HALF_PATCH_SIZE) -> jnp.ndarray:
    """Orientation in degrees [0, 360) for integer keypoint coords (N, 2)."""
    patches = extract_patches(img, xy.astype(jnp.int32), half_patch)
    return ic_angle_from_patches(patches, half_patch)

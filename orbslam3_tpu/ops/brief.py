"""Rotated BRIEF (rBRIEF) 256-bit descriptors.

Behavioral reference: /root/reference/src/cuda/Orb_gpu.cu calcOrb_kernel —
for each of 256 point pairs (p, q) from the standard learned ORB pattern
(Rublee et al. 2011; the constant table originates from OpenCV and is
stored here as data in orbslam3_tpu/data/orb_pattern.npy), sample the
5x5-Gaussian-blurred image at the pattern points rotated by the keypoint
angle (round-to-nearest), and set bit k iff I(p) < I(q).

Design: one gather of shape (N, 512) instead of 256 serial reads per
thread; bit packing via a weighted sum with a power-of-two vector.
Descriptors are returned both bit-packed (N, 8) uint32 for Hamming popcount
matmuls and that is the canonical storage format.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

_PATTERN_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "data", "orb_pattern.npy")


@functools.lru_cache(maxsize=None)
def pattern() -> np.ndarray:
    """(512, 2) int32 pattern points (x, y); pairs are (2k, 2k+1)."""
    return np.load(_PATTERN_PATH)


N_ANGLE_BINS = 32  # 11.25 deg granularity (the original ORB paper uses 30)
_PATCH_R = 19      # max |rotated pattern point| = ceil(13 * sqrt(2))


@functools.lru_cache(maxsize=None)
def _binned_offsets(n_bins: int = N_ANGLE_BINS):
    """(n_bins, 512, 2) integer pattern offsets rotated to each bin center
    (round-half-even, like __float2int_rn in the reference kernel)."""
    pat = pattern().astype(np.float64)
    out = np.zeros((n_bins, 512, 2), np.int32)
    for b in range(n_bins):
        a = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(a), np.sin(a)
        rx = np.rint(pat[:, 0] * ca - pat[:, 1] * sa)
        ry = np.rint(pat[:, 0] * sa + pat[:, 1] * ca)
        out[b, :, 0] = rx
        out[b, :, 1] = ry
    return out


@functools.lru_cache(maxsize=None)
def _bin_select_matrices(n_bins: int = N_ANGLE_BINS):
    """(n_bins, (2r+1)^2, 512) one-hot in-patch sampling matrices."""
    S = 2 * _PATCH_R + 1
    off = _binned_offsets(n_bins)
    sel = np.zeros((n_bins, S * S, 512), np.float32)
    for b in range(n_bins):
        flat = (off[b, :, 1] + _PATCH_R) * S + (off[b, :, 0] + _PATCH_R)
        sel[b, flat, np.arange(512)] = 1.0
    return sel


def descriptors_from_patches(P: jnp.ndarray, angle_deg: jnp.ndarray,
                             n_bins: int = N_ANGLE_BINS) -> jnp.ndarray:
    """Binned-BRIEF from pre-extracted flattened (N, S*S) blurred patches
    (S = 2 * _PATCH_R + 1)."""
    N = P.shape[0]
    bins = jnp.round(angle_deg * (n_bins / 360.0)).astype(jnp.int32) % n_bins
    sel = jnp.asarray(_bin_select_matrices(n_bins))  # (B, S*S, 512)
    vals = jnp.zeros((N, 512), jnp.float32)
    for b in range(n_bins):
        mask = (bins == b).astype(jnp.float32)[:, None]
        vals = vals + jnp.dot(P * mask, sel[b],
                              preferred_element_type=jnp.float32)
    t0 = vals[:, 0::2]
    t1 = vals[:, 1::2]
    bits = (t0 < t1).astype(jnp.uint32)  # (N, 256)
    shifts = jnp.asarray(1 << np.arange(32, dtype=np.uint32), jnp.uint32)
    words = jnp.sum(bits.reshape(-1, 8, 32) * shifts[None, None, :], axis=-1)
    return words.astype(jnp.uint32)


def compute_descriptors(img_blurred: jnp.ndarray, xy: jnp.ndarray,
                        angle_deg: jnp.ndarray,
                        n_bins: int = N_ANGLE_BINS) -> jnp.ndarray:
    """Descriptors for N keypoints (discrete-orientation formulation).

    Design: quantizing the orientation to `n_bins` steps (the original
    ORB paper itself used 30 discrete orientations; the reference kernel
    rotates continuously) turns the per-keypoint rotated sampling gather
    into per-bin one-hot MATMULS over 39x39 patches: patches are one
    vmapped dynamic-slice, and each bin contributes a masked
    (N x S^2) @ (S^2 x 512) product.  This is the plain reference of the
    Pallas kernel in ops/describe_kernel.py, which samples directly.

    Returns (N, 8) uint32 (256 bits; word w bit b = pair index 32w+b).
    """
    h, w = img_blurred.shape
    S = 2 * _PATCH_R + 1
    N = xy.shape[0]
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - _PATCH_R, 0, w - S)
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - _PATCH_R, 0, h - S)

    def slice_one(y, x):
        return jax.lax.dynamic_slice(img_blurred, (y, x), (S, S))

    P = jax.vmap(slice_one)(y0, x0).reshape(N, S * S)
    return descriptors_from_patches(P, angle_deg, n_bins)


def compute_descriptors_exact(img_blurred: jnp.ndarray, xy: jnp.ndarray,
                              angle_deg: jnp.ndarray) -> jnp.ndarray:
    """Continuous-rotation reference formulation (gather-based; exact
    parity with the reference CUDA kernel — kept as oracle and for
    offline use).
    """
    h, w = img_blurred.shape
    pat = jnp.asarray(pattern(), jnp.float32)  # (512, 2) x, y
    ang = angle_deg * (jnp.pi / 180.0)
    ca, sa = jnp.cos(ang), jnp.sin(ang)  # (N,)

    px, py = pat[:, 0], pat[:, 1]  # (512,)
    # rotated integer offsets, round-half-to-even like __float2int_rn
    rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    gx = jnp.clip(jnp.round(xy[:, 0:1]) + rx, 0, w - 1).astype(jnp.int32)
    gy = jnp.clip(jnp.round(xy[:, 1:2]) + ry, 0, h - 1).astype(jnp.int32)

    vals = img_blurred[gy, gx]  # (N, 512) gather
    t0 = vals[:, 0::2]
    t1 = vals[:, 1::2]
    bits = (t0 < t1).astype(jnp.uint32)  # (N, 256)

    shifts = jnp.asarray(1 << np.arange(32, dtype=np.uint32), jnp.uint32)
    words = jnp.sum(bits.reshape(-1, 8, 32) * shifts[None, None, :], axis=-1)
    return words.astype(jnp.uint32)  # (N, 8)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) float {0,1} (for popcount-by-matmul)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return b.reshape(desc.shape[0], 256).astype(jnp.float32)


def hamming_distance(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distance (Na, 8)x(Nb, 8) uint32 -> (Na, Nb) int32.

    popcount(a XOR b) = |a| + |b| - 2 a.b on the unpacked bit vectors —
    one (Na, 256) @ (256, Nb) matmul, replacing the reference's per-pair
    popcount bit hack (src/ORBmatcher.cc:1375).  The operands are 0/1
    and the sums integers <= 256, exact at any matmul precision.
    """
    A = unpack_bits(desc_a)
    B = unpack_bits(desc_b)
    na = jnp.sum(A, axis=1, keepdims=True)
    nb = jnp.sum(B, axis=1, keepdims=True)
    dot = jnp.dot(A, B.T, preferred_element_type=jnp.float32)
    return (na + nb.T - 2.0 * dot).astype(jnp.int32)

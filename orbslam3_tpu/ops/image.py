"""Image ops for the ORB front-end: pyramid resize + Gaussian blur.

Reference recipe (src/ORBextractor.cc:607-623 ComputePyramid): level L is a
bilinear resize of level L-1 by 1/scaleFactor; every level additionally gets
a 5x5 Gaussian (sigma=1.2, BORDER_REFLECT_101 — src/ORBextractor.cc:145)
used only for descriptor sampling.  FAST/orientation run on the unblurred
pyramid.

Design: images are f32 (0..255) arrays; resize via jax.image (bilinear,
half-pixel convention, same as cv::resize INTER_LINEAR); blur as two
banded matmuls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static per-level (h, w), matching cvRound(dim * invScale^L)
    (reference src/ORBextractor.cc:596-599)."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor ** lv)
        # cvRound = round-half-to-even
        shapes.append((int(np.rint(h * s)), int(np.rint(w * s))))
    return shapes


def resize_bilinear(img: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    return jax.image.resize(img, out_hw, method="linear")


@functools.lru_cache(maxsize=None)
def _gauss_kernel_np(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_band_np(n: int, ksize: int, sigma: float) -> np.ndarray:
    """(n, n) banded 1-D Gaussian operator with BORDER_REFLECT_101 folded
    into the boundary rows: out = B @ x."""
    k = _gauss_kernel_np(ksize, sigma).astype(np.float64)
    r = ksize // 2
    B = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(-r, r + 1):
            j = i + t
            if j < 0:
                j = -j          # reflect-101: -1 -> 1
            elif j >= n:
                j = 2 * (n - 1) - j
            B[i, j] += k[t + r]
    return B.astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 5, sigma: float = 1.2) -> jnp.ndarray:
    """Separable Gaussian with reflect-101 border (cv BORDER_REFLECT_101).

    Design: the operator as two banded matmuls (out = Bv @ img @ Bh^T,
    boundary reflection folded into the band matrices) instead of a
    1-input-channel convolution.  HIGHEST matmul precision keeps the
    result f32-exact (a reduced-precision matmul would perturb blurred
    intensities by ~1 graylevel and flip near-tie BRIEF comparisons).
    """
    h, w = img.shape
    Bv = jnp.asarray(_blur_band_np(h, ksize, sigma))
    Bh = jnp.asarray(_blur_band_np(w, ksize, sigma))
    hi = jax.lax.Precision.HIGHEST
    return jnp.dot(Bv, jnp.dot(img, Bh.T, precision=hi), precision=hi)


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float):
    """Returns (pyramid, blurred_pyramid) — lists of per-level images.

    Static shapes per level; the whole chain lives in one jit trace.
    """
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    pyr = [img]
    for lv in range(1, n_levels):
        pyr.append(resize_bilinear(pyr[-1], shapes[lv]))
    # Round blurred levels to integers, matching the reference's uint8
    # blurred image (cv::GaussianBlur on 8U).  This also makes the BRIEF
    # one-hot sampling matmuls exact at any matmul precision: integers
    # 0..255 survive bf16/TF32 input rounding.
    blurred = [jnp.round(gaussian_blur(p)) for p in pyr]
    return pyr, blurred

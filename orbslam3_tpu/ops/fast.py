"""FAST-9 corner detection as a vectorized stencil (whole-image, VPU-shaped).

Behavioral reference: the CUDA tile kernel in
/root/reference/src/cuda/Fast_gpu.cu (calcKeypoints + cornerScore binary
search + 3x3 nonmaxSuppression).  Semantics implemented here:

  * corner test: >= 9 contiguous pixels of the 16-pixel Bresenham circle
    (radius 3) all brighter than center+th or all darker than center-th;
  * score: the largest threshold at which the pixel is still a corner
    (the reference binary-searches this; the closed form is
    max over the 16 length-9 windows of the window-min brightness excess,
    minus one — identical value, computed branch-free);
  * NMS: keep pixels whose score is a strict 3x3 local max (ties broken
    toward the lexicographically-first pixel to keep determinism).

Design: instead of per-pixel threads, we materialize the 16 circle
taps via jnp.roll (XLA turns these into cheap shifted slices) and reduce
with log-depth min/max trees — pure VPU work, fully fused.
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle radius 3, clockwise from 12 o'clock (dy, dx) — the
# standard FAST-9/16 tap set.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score(img: jnp.ndarray, border: int = 3) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score; 0 where not a corner at th=1.

    img: (H, W) f32.  Returns (H, W) f32 score (integer-valued).
    A pixel is a corner at threshold `th` iff score >= th.
    """
    taps = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for (dy, dx) in CIRCLE]
    c = jnp.stack(taps, axis=0)  # (16, H, W): c[k] = img[y+dy_k, x+dx_k]
    d_bright = c - img[None]          # window-min of this > th  => bright corner
    d_dark = img[None] - c

    def max_min9(d):
        # min over 9 contiguous entries starting at each of the 16 positions
        m1 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
        m2 = jnp.minimum(m1, jnp.roll(m1, -2, axis=0))
        m4 = jnp.minimum(m2, jnp.roll(m2, -4, axis=0))
        w9 = jnp.minimum(m4, jnp.roll(d, -8, axis=0))
        return jnp.max(w9, axis=0)

    score = jnp.maximum(max_min9(d_bright), max_min9(d_dark)) - 1.0
    score = jnp.maximum(score, 0.0)

    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    b = max(border, 3)
    valid = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    return jnp.where(valid, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression; returns score where local max else 0.

    Strict '>' against the 4 lexicographically-earlier neighbors and '>='
    against the later 4 — deterministic single winner for plateaus of 2.
    """
    s = score
    earlier = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    later = [(0, 1), (1, -1), (1, 0), (1, 1)]
    keep = s > 0
    for dy, dx in earlier:
        keep &= s > jnp.roll(s, (-dy, -dx), axis=(0, 1))
    for dy, dx in later:
        keep &= s >= jnp.roll(s, (-dy, -dx), axis=(0, 1))
    return jnp.where(keep, s, 0.0)


def detect(img: jnp.ndarray, threshold: float, border: int = 3) -> jnp.ndarray:
    """Score map after threshold + NMS (0 = no corner)."""
    s = fast_score(img, border)
    s = jnp.where(s >= threshold, s, 0.0)
    return nms3x3(s)

"""Descriptor matching: one masked Hamming-NN kernel covering the
reference ORBmatcher strategy family (src/ORBmatcher.cc — SearchByProjection
:31, SearchByBoW :133, SearchForInitialization :329, SearchForTriangulation
:441, Fuse :678/864).

Design: the reference prunes candidates with per-keypoint grid lookups
and BoW buckets because CPU Hamming is expensive; on an accelerator the
full (N x M) distance matrix is ONE 256-wide matmul (~0.4 GFLOP for
1200x1200), so every strategy reduces to
  distance matrix + strategy-specific compatibility mask + argmin + gates.
Thresholds mirror include/ORBmatcher.h:73-75: TH_LOW=50, TH_HIGH=100,
HISTO_LENGTH=30.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import brief

TH_LOW = 30   # this fork tightened TH_LOW from upstream's 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = jnp.int32(1 << 20)


class Matches(NamedTuple):
    idx: jnp.ndarray    # (N,) int32 index into B per A row, -1 if none
    dist: jnp.ndarray   # (N,) int32 best Hamming distance
    valid: jnp.ndarray  # (N,) bool


def rotation_histogram_filter(rot_deg: jnp.ndarray, valid: jnp.ndarray,
                              n_keep: int = 3) -> jnp.ndarray:
    """Keep matches whose relative rotation falls in the top-`n_keep` of
    HISTO_LENGTH bins (reference ORBmatcher rotation-consistency check)."""
    rot = jnp.mod(rot_deg, 360.0)
    b = jnp.round(rot * (HISTO_LENGTH / 360.0)).astype(jnp.int32)
    b = jnp.where(b == HISTO_LENGTH, 0, b)
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[b].add(valid.astype(jnp.int32))
    top_counts, top_bins = jax.lax.top_k(hist, n_keep)
    # reference ComputeThreeMaxima: drop 2nd/3rd maxima below 10% of the 1st
    keep_bin = top_counts.astype(jnp.float32) >= 0.1 * top_counts[0]
    in_top = ((b[:, None] == top_bins[None, :]) & keep_bin[None, :]).any(axis=-1)
    return valid & in_top


def match_nn(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
             mask: jnp.ndarray | None = None,
             max_dist: int = TH_LOW,
             nn_ratio: float | None = None,
             mutual: bool = False,
             angles_a: jnp.ndarray | None = None,
             angles_b: jnp.ndarray | None = None,
             check_rotation: bool = False) -> Matches:
    """Nearest-neighbor Hamming matching A->B with gates.

    mask: (N, M) bool of allowed pairs (geometric compatibility).
    nn_ratio: best < ratio * second-best (the reference's mfNNratio).
    mutual: also require A is B's best (used where the reference matches
    both directions / marks taken targets).
    """
    d = brief.hamming_distance(desc_a, desc_b)  # (N, M) int32
    if mask is not None:
        d = jnp.where(mask, d, BIG)

    # top-2 via min over masked argmin
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)

    valid = best <= max_dist
    if nn_ratio is not None:
        valid &= best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32)
    if mutual:
        col_best = jnp.argmin(d, axis=0)  # (M,)
        valid &= col_best[best_idx] == jnp.arange(d.shape[0])
    if check_rotation:
        rot = angles_a - angles_b[best_idx]
        valid = rotation_histogram_filter(rot, valid)

    # resolve duplicate targets: keep the lowest-distance row per column
    # (the reference overwrites earlier matches when a closer one arrives).
    # key = dist * n + row must stay in int32: clamp dist to 9 bits (any
    # value > 256 is already invalid for 256-bit descriptors).
    n = d.shape[0]
    sentinel = jnp.iinfo(jnp.int32).max
    order_key = jnp.minimum(best, 512) * n + jnp.arange(n)
    # winner per column = row with min (dist, row) among rows matched to it
    col_winner = jnp.full(d.shape[1], sentinel, jnp.int32)
    col_winner = col_winner.at[best_idx].min(jnp.where(valid, order_key,
                                                       sentinel))
    valid &= col_winner[best_idx] == order_key

    return Matches(idx=jnp.where(valid, best_idx, -1),
                   dist=best, valid=valid)


# ---------------------------------------------------------------------------
# Strategy-specific compatibility masks
# ---------------------------------------------------------------------------

def window_mask(xy_a: jnp.ndarray, xy_b: jnp.ndarray, radius: float,
                octave_a: jnp.ndarray | None = None,
                octave_b: jnp.ndarray | None = None,
                max_octave: int | None = None) -> jnp.ndarray:
    """|xy_a - xy_b| window search (SearchForInitialization — the reference
    restricts to octave 0 via GetFeaturesInArea(level 0, 0))."""
    dx = xy_a[:, None, 0] - xy_b[None, :, 0]
    dy = xy_a[:, None, 1] - xy_b[None, :, 1]
    m = (jnp.abs(dx) <= radius) & (jnp.abs(dy) <= radius)
    if max_octave is not None:
        m &= (octave_a[:, None] <= max_octave) & (octave_b[None, :] <= max_octave)
    return m


def projection_mask(uv_proj: jnp.ndarray, pred_octave: jnp.ndarray,
                    proj_valid: jnp.ndarray, xy_f: jnp.ndarray,
                    octave_f: jnp.ndarray, kp_valid: jnp.ndarray,
                    scale_factors: jnp.ndarray, radius_th: float) -> jnp.ndarray:
    """SearchByProjection gate (src/ORBmatcher.cc:31-124): map point
    projected at uv with predicted octave; search radius = radius_th *
    scale_factor[pred_octave]; keypoint octave in [pred-1, pred+1].

    uv_proj: (P, 2), pred_octave: (P,), proj_valid: (P,);
    xy_f/octave_f/kp_valid: (N,) frame keypoints.  Returns (P, N).
    """
    r = radius_th * scale_factors[jnp.clip(pred_octave, 0,
                                           scale_factors.shape[0] - 1)]
    du = uv_proj[:, None, 0] - xy_f[None, :, 0]
    dv = uv_proj[:, None, 1] - xy_f[None, :, 1]
    close = (jnp.abs(du) <= r[:, None]) & (jnp.abs(dv) <= r[:, None])
    oct_ok = (octave_f[None, :] >= (pred_octave - 1)[:, None]) & \
             (octave_f[None, :] <= (pred_octave + 1)[:, None])
    return close & oct_ok & proj_valid[:, None] & kp_valid[None, :]


def epipolar_mask(xy_a: jnp.ndarray, xy_b: jnp.ndarray, F12: jnp.ndarray,
                  sigma2_b: jnp.ndarray, chi2_th: float = 3.84) -> jnp.ndarray:
    """Point-to-epipolar-line gate for SearchForTriangulation
    (reference Pinhole::epipolarConstrain, src/CameraModels/Pinhole.cpp:104:
    squared line distance < 3.84 * sigma2 of the matched keypoint)."""
    ones_a = jnp.ones((xy_a.shape[0], 1), xy_a.dtype)
    pa = jnp.concatenate([xy_a, ones_a], axis=1)  # (N, 3)
    lines = pa @ F12.T  # (N, 3) epipolar lines in image b
    num = lines[:, None, 0] * xy_b[None, :, 0] + \
        lines[:, None, 1] * xy_b[None, :, 1] + lines[:, None, 2:3][..., 0]
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    dsqr = (num * num) / (den + 1e-12)
    return dsqr < chi2_th * sigma2_b[None, :]


def search_for_initialization(ff1, ff2, radius: float = 100.0,
                              nn_ratio: float = 0.9) -> Matches:
    """Two-frame initialization matching (reference
    Tracking::MonocularInitialization -> SearchForInitialization with
    windowSize=100 upstream; the fork node passes 40)."""
    mask = window_mask(ff1.xy, ff2.xy, radius,
                       ff1.octave, ff2.octave, max_octave=0)
    mask &= ff1.valid[:, None] & ff2.valid[None, :]
    return match_nn(ff1.desc, ff2.desc, mask, max_dist=TH_LOW,
                    nn_ratio=nn_ratio, angles_a=ff1.angle,
                    angles_b=ff2.angle, check_rotation=True)


def search_by_brute_force(ff1, ff2, nn_ratio: float = 0.7,
                          max_dist: int = TH_LOW,
                          check_rotation: bool = True) -> Matches:
    """Stand-in for SearchByBoW: the BoW shared-node constraint existed to
    cut CPU cost; the matmul matcher searches all pairs exactly, which
    is a superset (>= recall) at equal gates."""
    mask = ff1.valid[:, None] & ff2.valid[None, :]
    return match_nn(ff1.desc, ff2.desc, mask, max_dist=max_dist,
                    nn_ratio=nn_ratio, angles_a=ff1.angle,
                    angles_b=ff2.angle, check_rotation=check_rotation)

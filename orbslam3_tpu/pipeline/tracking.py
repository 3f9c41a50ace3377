"""Per-frame tracking steps (jitted kernels orchestrated by System).

Parity target: reference Tracking (src/Tracking.cc) — the monocular path:
  * motion-model pose prediction (const velocity; PredictStateIMU when
    inertial — pipeline/inertial wiring comes with the VI stage),
  * TrackLocalMap: project map points, SearchByProjection radius gates
    (src/ORBmatcher.cc:31-124), pose-only optimization
    (src/Optimizer.cc:765),
  * keyframe decision thresholds (src/Tracking.cc:985-1005).

Each function here is one fused jit program over the fixed-capacity
MapState — the fixed-shape replacement for the reference's per-frame C++ loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..features.extractor import FeatureFrame
from ..ops import cameras, lie, matching
from ..slam_map import state as mapstate
from ..solver import pose_opt

_HI = jax.lax.Precision.HIGHEST


class TrackResult(NamedTuple):
    R: jnp.ndarray          # optimized R_cw
    t: jnp.ndarray
    n_matches: jnp.ndarray  # () matches fed to the optimizer
    n_inliers: jnp.ndarray  # () inliers after optimization
    kp_pt: jnp.ndarray      # (N,) map-point index per keypoint (-1 none)
    kp_inlier: jnp.ndarray  # (N,) bool
    pt_matched: jnp.ndarray  # (P,) bool — map points matched this frame
    pt_visible: jnp.ndarray  # (P,) bool — map points predicted visible


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale (reference src/MapPoint.cc:555)."""
    ratio = max_dist / jnp.maximum(dist, 1e-6)
    lv = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lv, 0, n_levels - 1)


def track_local_map(m: mapstate.MapState, ff: FeatureFrame,
                    R_guess, t_guess, cam_model: str, cam_params,
                    image_hw: tuple[int, int],
                    scale_factor: float = 1.2, n_levels: int = 8,
                    radius_th=4.0,
                    nn_ratio: float = 0.8,
                    view: mapstate.PointView | None = None) -> TrackResult:
    """Project the local map points into the predicted frame, match by
    projection gates, then pose-only optimize.

    The reference bounds per-frame cost by tracking against a LOCAL map
    (UpdateLocalKeyFrames/UpdateLocalPoints, src/Tracking.cc:2964-3090)
    plus visibility gating (Frame::isInFrustum, src/Frame.cc:296+).  Here
    `view` is that local map: a fixed-V gather of the covisibility
    neighborhood's points (state.gather_local_view), refreshed once per
    keyframe, so the per-frame (V, N) planes scale with the neighborhood
    rather than the map capacity.  `view=None` tracks against the whole
    capacity (the original behavior; still used at init time and by
    small-map callers).  Returned indices (`kp_pt`) and per-point flags
    (`pt_matched`/`pt_visible`) are always GLOBAL point slots.
    """
    h, w = image_hw
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))
    P = m.pt_xyz.shape[0]
    v = view if view is not None else mapstate.full_view(m)

    Xc = lie.se3_apply(R_guess, t_guess, v.xyz)
    uv = cameras.project(cam_model, cam_params, Xc)
    depth = Xc[..., 2]
    dist = jnp.linalg.norm(Xc, axis=-1)
    # viewing angle: cos(normal, view dir from camera center) > 0.5
    Ow = -jnp.einsum("ji,j->i", R_guess, t_guess, precision=_HI)
    vdir = v.xyz - Ow
    vdir = vdir / (jnp.linalg.norm(vdir, axis=-1, keepdims=True) + 1e-9)
    cos_view = jnp.sum(vdir * v.normal, axis=-1)
    has_normal = jnp.linalg.norm(v.normal, axis=-1) > 1e-6
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    dist_ok = (dist >= 0.8 * v.min_dist) & (dist <= 1.2 * v.max_dist)
    visible = v.valid & (depth > 0) & in_img & dist_ok & \
        (~has_normal | (cos_view > 0.5))

    pred_oct = predict_scale(dist, v.max_dist, scale_factor, n_levels)
    mask = matching.projection_mask(uv, pred_oct, visible, ff.xy, ff.octave,
                                    ff.valid, sf, radius_th)
    mm = matching.match_nn(v.desc, ff.desc, mask,
                           max_dist=matching.TH_HIGH, nn_ratio=nn_ratio)
    # mm.idx: keypoint index per view slot
    V = v.xyz.shape[0]
    N = ff.xy.shape[0]
    kp_pt = jnp.full(N, -1, jnp.int32)
    kp_pt = kp_pt.at[jnp.where(mm.valid, mm.idx, N)].set(
        jnp.arange(V), mode="drop")
    matched_kp = kp_pt >= 0

    inv_sigma2 = 1.0 / sf[jnp.clip(ff.octave, 0, n_levels - 1)] ** 2
    X_for_kp = v.xyz[jnp.clip(kp_pt, 0, V - 1)]
    res = pose_opt.pose_optimization(
        R_guess, t_guess, X_for_kp, ff.xy, inv_sigma2,
        matched_kp & ff.valid, cam_model, cam_params)

    # globalize: view slots -> global point slots
    kp_pt_g = jnp.where(matched_kp, v.idx[jnp.clip(kp_pt, 0, V - 1)], -1)
    if view is None:
        pt_matched = jnp.zeros(P, bool).at[
            jnp.where(mm.valid, jnp.arange(P), P)].set(True, mode="drop")
        pt_visible = visible
    else:
        pt_matched = jnp.zeros(P, bool).at[
            jnp.where(mm.valid & (v.idx >= 0), v.idx, P)].set(
            True, mode="drop")
        pt_visible = jnp.zeros(P, bool).at[
            jnp.where(visible & (v.idx >= 0), v.idx, P)].set(
            True, mode="drop")
    return TrackResult(
        R=res.R, t=res.t,
        n_matches=jnp.sum(matched_kp.astype(jnp.int32)),
        n_inliers=res.n_inliers,
        kp_pt=jnp.where(res.inliers, kp_pt_g, -1),
        kp_inlier=res.inliers,
        pt_matched=pt_matched,
        pt_visible=pt_visible)


def update_point_stats(m: mapstate.MapState, tr: TrackResult) -> mapstate.MapState:
    """Increase Visible/Found counters (reference MapPoint::IncreaseVisible/
    IncreaseFound via Tracking::SearchLocalPoints)."""
    return m._replace(
        pt_visible=m.pt_visible + tr.pt_visible.astype(jnp.int32),
        pt_found=m.pt_found + tr.pt_matched.astype(jnp.int32))

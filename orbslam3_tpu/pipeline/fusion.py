"""Map maintenance: duplicate-point fusion, keyframe culling, and point
statistic refresh.

Parity targets:
  * ORBmatcher::Fuse (src/ORBmatcher.cc:678): project each map point into
    a target keyframe, find the best descriptor match in a scale-gated
    radius; if the matched keypoint already has a map point, merge the two
    (keep the one with more observations — MapPoint::Replace,
    src/MapPoint.cc:262); else add the observation.
  * LocalMapping::SearchInNeighbors (src/LocalMapping.cc:764): run Fuse
    between the current KF and ~10-30 covisible neighbors, both ways.
  * LocalMapping::KeyFrameCulling (src/LocalMapping.cc:902): a KF is
    redundant if >= 90% of its points are seen by >= 3 other KFs at the
    same-or-finer scale (disabled in the fork due to segfaults — the SoA
    map has no pointer lifetime problem, so it is enabled here).
  * MapPoint::ComputeDistinctiveDescriptors (src/MapPoint.cc:343): the
    representative descriptor minimizes the median Hamming distance to
    the point's other observations.  Our SoA map stores only the
    creation-time descriptor per point; the fused variant refreshes it
    from the latest observation set held by the keyframe features.

All ops are fixed-shape masked kernels over the map arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import cameras, lie, matching
from ..slam_map import state as mapstate

_HI = jax.lax.Precision.HIGHEST


def fuse_into_keyframe(m: mapstate.MapState, kf_idx, ff, kp_pt,
                       cam_model: str, cam_params,
                       image_hw, scale_factor: float = 1.2,
                       n_levels: int = 8, radius_th: float = 3.0):
    """Fuse map points into one keyframe's features.

    For every valid map point projected into KF `kf_idx`, find the best
    descriptor match among the KF's keypoints (radius+scale gated).  If
    the keypoint is unbound, bind it (new observation).  If it is bound to
    a DIFFERENT point, merge: the point with more observations absorbs
    the other (the loser's pt_valid is cleared and its observations are
    re-pointed — realized here by marking the loser invalid; its
    observations are dropped by the validity product in consumers).

    Returns (map, kp_pt updated, n_fused).
    """
    h, w = image_hw
    P = m.pt_xyz.shape[0]
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))

    R, t = m.kf_R[kf_idx], m.kf_t[kf_idx]
    Xc = lie.se3_apply(R, t, m.pt_xyz)
    uv = cameras.project(cam_model, cam_params, Xc)
    depth = Xc[..., 2]
    dist = jnp.linalg.norm(Xc, axis=-1)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < h)
    dist_ok = (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist)
    visible = m.pt_valid & (depth > 0) & in_img & dist_ok

    pred_oct = jnp.clip(
        jnp.ceil(jnp.log(m.pt_max_dist / jnp.maximum(dist, 1e-6)) /
                 jnp.log(scale_factor)).astype(jnp.int32), 0, n_levels - 1)
    mask = matching.projection_mask(uv, pred_oct, visible, ff.xy, ff.octave,
                                    ff.valid, sf, radius_th)
    mm = matching.match_nn(m.pt_desc, ff.desc, mask,
                           max_dist=matching.TH_LOW)
    # per map point: matched keypoint j (or -1)
    j = mm.idx
    jc = jnp.maximum(j, 0)
    existing = kp_pt[jc]                      # point already bound to kp j
    same = existing == jnp.arange(P)
    is_new_obs = mm.valid & (existing < 0)
    is_conflict = mm.valid & (existing >= 0) & ~same

    # observation counts decide the merge direction
    nobs = mapstate.point_obs_count(m)
    other = jnp.clip(existing, 0, P - 1)
    i_wins = nobs >= nobs[other]
    # loser invalidation (conflict only)
    lose_self = is_conflict & ~i_wins         # this point absorbed by other
    lose_other_pt = jnp.where(is_conflict & i_wins, other, P)
    pt_valid = m.pt_valid & ~lose_self
    pt_valid = pt_valid.at[jnp.clip(lose_other_pt, 0, P - 1)].set(
        jnp.where(lose_other_pt < P, False,
                  pt_valid[jnp.clip(lose_other_pt, 0, P - 1)]), mode="drop")

    # bind new observations
    winners = is_new_obs | (is_conflict & i_wins)
    kp_pt2 = kp_pt.at[jnp.where(winners, jc, ff.xy.shape[0])].set(
        jnp.arange(P), mode="drop")
    m2 = m._replace(pt_valid=pt_valid)
    m2 = mapstate.add_observations(
        m2, kf_idx, jnp.where(winners, jnp.arange(P), -1),
        ff.xy[jc], ff.octave[jc], winners)
    n_fused = jnp.sum(is_conflict.astype(jnp.int32))
    return m2, kp_pt2, n_fused


def keyframe_redundancy(m: mapstate.MapState, kf_idx,
                        redundant_th: float = 0.9,
                        min_other_obs: int = 3):
    """KeyFrameCulling redundancy check for one keyframe: fraction of its
    observed points that >= 3 OTHER keyframes also observe.  Returns
    (is_redundant, fraction)."""
    P = m.pt_xyz.shape[0]
    obs_pt_c = jnp.clip(m.obs_pt, 0, P - 1)
    ok = m.obs_valid & m.pt_valid[obs_pt_c]
    mine = ok & (m.obs_kf == kf_idx)
    # per point: total obs and whether this KF observes it
    tot = jnp.zeros(P, jnp.int32).at[obs_pt_c].add(ok.astype(jnp.int32))
    seen_by_me = jnp.zeros(P, bool).at[obs_pt_c].max(mine)
    n_mine = jnp.sum(seen_by_me.astype(jnp.int32))
    redundant_pts = seen_by_me & (tot - 1 >= min_other_obs)
    frac = jnp.sum(redundant_pts.astype(jnp.float32)) / \
        jnp.maximum(n_mine.astype(jnp.float32), 1.0)
    return (frac >= redundant_th) & (n_mine > 0), frac


def redundancy_window(m: mapstate.MapState, center_kf, window: int = 8,
                      protect_recent: int = 3,
                      redundant_th: float = 0.9,
                      min_other_obs: int = 3):
    """Vectorized redundancy flags for KFs in (center-window, center-
    protect_recent]; KF0/KF1 are never candidates.  Returns (K,) bool."""
    K = m.kf_R.shape[0]
    ids = jnp.arange(K)
    cand = (ids > jnp.maximum(center_kf - window, 1)) &            (ids <= center_kf - protect_recent) & m.kf_valid

    def one(k):
        red, _ = keyframe_redundancy(m, k, redundant_th, min_other_obs)
        return red

    flags = jax.vmap(one)(ids)
    return flags & cand


def cull_keyframe(m: mapstate.MapState, kf_idx) -> mapstate.MapState:
    """Remove a redundant keyframe: invalidate it and its observations
    (reference KeyFrame::SetBadFlag, src/KeyFrame.cc:652 — minus the
    pointer surgery the SoA layout makes unnecessary)."""
    drop = m.obs_valid & (m.obs_kf == kf_idx)
    return m._replace(
        kf_valid=m.kf_valid.at[kf_idx].set(False),
        obs_valid=m.obs_valid & ~drop)


def refresh_point_descriptors(m: mapstate.MapState, ff, kp_pt) -> \
        mapstate.MapState:
    """ComputeDistinctiveDescriptors (reference src/MapPoint.cc:343): the
    representative descriptor is the observation descriptor minimizing the
    MEDIAN Hamming distance to the point's other observation descriptors.

    The SoA map keeps a ring reservoir of each point's M most recent
    observation descriptors (`pt_desc_hist`, slot = count % M).  Here we
    (1) push the new KF's descriptor for every re-observed point and
    (2) recompute the min-median descriptor for exactly those points with
    one small batched popcount: the N touched points' (M, M) pairwise
    distance cubes are (N, M, 256) bit tensors contracted as matmuls —
    no host loop, no bank search."""
    P = m.pt_xyz.shape[0]
    M = m.pt_desc_hist.shape[1]
    pt = jnp.clip(kp_pt, 0, P - 1)
    upd = (kp_pt >= 0) & ff.valid
    safe_pt = jnp.where(upd, pt, P)

    # 1) push into the ring reservoir
    slot = m.pt_desc_n[pt] % M
    hist = m.pt_desc_hist.at[safe_pt, slot].set(ff.desc, mode="drop")
    desc_n = m.pt_desc_n.at[safe_pt].add(1, mode="drop")

    # 2) min-median-Hamming over each touched point's reservoir
    h = hist[pt]                                   # (N, M, 8) uint32
    nvals = jnp.minimum(desc_n[pt], M)             # (N,)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((h[..., None] >> shifts) & jnp.uint32(1)).reshape(
        h.shape[0], M, 256).astype(jnp.float32)    # (N, M, 256)
    ones = jnp.sum(bits, axis=-1)                  # (N, M)
    dot = jnp.einsum("nmb,nkb->nmk", bits, bits,
                     precision=_HI)                # (N, M, M)
    D = ones[:, :, None] + ones[:, None, :] - 2.0 * dot
    BIG = 1e9
    slot_ok = jnp.arange(M)[None, :] < nvals[:, None]   # (N, M)
    # distances to invalid slots never count; the self-distance 0 is kept,
    # matching the reference's vDists (it includes Distances[i][i] = 0)
    Dm = jnp.where(slot_ok[:, None, :], D, BIG)
    Ds = jnp.sort(Dm, axis=-1)                     # (N, M, M)
    med_idx = jnp.maximum(nvals - 1, 0) // 2       # (N,)
    med = jnp.take_along_axis(
        Ds, med_idx[:, None, None].astype(jnp.int32).repeat(M, 1), axis=-1
    )[..., 0]                                      # (N, M)
    med = jnp.where(slot_ok, med, BIG)
    best = jnp.argmin(med, axis=-1)                # (N,)
    best_desc = jnp.take_along_axis(
        h, best[:, None, None].repeat(8, 2), axis=1)[:, 0]   # (N, 8)
    desc = m.pt_desc.at[safe_pt].set(best_desc, mode="drop")
    return m._replace(pt_desc=desc, pt_desc_hist=hist, pt_desc_n=desc_n)

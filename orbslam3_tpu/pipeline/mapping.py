"""Local mapping steps: keyframe insertion, new-point triangulation,
culling, local BA windows.

Parity target: reference LocalMapping::Run stages (src/LocalMapping.cc):
ProcessNewKeyFrame (:321), MapPointCulling (:371), CreateNewMapPoints
(:413-726 — epipolar search + triangulation + 6 acceptance gates),
local BA dispatch (:117-152).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..features.extractor import FeatureFrame
from ..ops import cameras, lie, matching, triangulate
from ..slam_map import state as mapstate
from ..solver import ba

_HI = jax.lax.Precision.HIGHEST


def fundamental_from_poses(R1, t1, R2, t2, K4):
    """F21 mapping image-1 points to epilines in image 2 (x2^T F21 x1 = 0)
    for pinhole K (reference ORBmatcher computes F12 via ComputeF12)."""
    # relative pose: cam1 -> cam2
    R21 = jnp.matmul(R2, R1.T, precision=_HI)
    t21 = t2 - jnp.einsum("ij,j->i", R21, t1, precision=_HI)
    E = jnp.matmul(lie.hat(t21), R21, precision=_HI)
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    Kinv = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    Kinv = Kinv.at[0, 0].set(1.0 / fx).at[1, 1].set(1.0 / fy) \
               .at[0, 2].set(-cx / fx).at[1, 2].set(-cy / fy)
    return Kinv.T @ E @ Kinv


class NewPoints(NamedTuple):
    xyz: jnp.ndarray       # (N,3) world
    valid: jnp.ndarray     # (N,) bool
    kp_cur: jnp.ndarray    # (N,) keypoint index in current frame
    kp_prev: jnp.ndarray   # (N,) matched keypoint index in prev KF
    score: jnp.ndarray     # (N,) cos(parallax) — lower = better baseline


def triangulate_new_points(ff_cur: FeatureFrame, ff_prev: FeatureFrame,
                           cur_unmatched: jnp.ndarray,
                           prev_unmatched: jnp.ndarray,
                           R_cur, t_cur, R_prev, t_prev,
                           cam_model: str, cam_params, K4,
                           scale_factor: float = 1.2,
                           n_levels: int = 8) -> NewPoints:
    """Epipolar-gated matching of unmatched keypoints + DLT triangulation
    with the reference's acceptance gates (src/LocalMapping.cc:571-723):
      1. epipolar constraint (3.84 sigma2),
      2. sufficient parallax: cosParallaxRays < 0.9998,
      3. positive depth in both views,
      4. reprojection chi2 < 5.991 sigma2 in both views,
      5. scale-consistency ratio between the two octaves (factor 1.5).
    """
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))
    sigma2 = sf ** 2
    # epipolar-gated descriptor matching prev <- cur
    if cam_model == "pinhole":
        F_cp = fundamental_from_poses(R_cur, t_cur, R_prev, t_prev, K4)
        epi = matching.epipolar_mask(ff_cur.xy, ff_prev.xy, F_cp,
                                     sigma2[jnp.clip(ff_prev.octave, 0,
                                                     n_levels - 1)])
    else:
        # fisheye (KB8): gate in ray space, not on distorted pixels — the
        # reference checks the epipolar constraint on unprojected bearings
        # (src/CameraModels/KannalaBrandt8.cpp:306).  We map bearings onto
        # a unit virtual pinhole (z=1 plane) and scale the pixel sigma by
        # the focal length, like TwoViewReconstruction's KB8 path.
        b_c = cameras.unproject(cam_model, cam_params, ff_cur.xy)
        b_p = cameras.unproject(cam_model, cam_params, ff_prev.xy)
        n_c = b_c[:, :2] / jnp.maximum(b_c[:, 2:3], 1e-3)
        n_p = b_p[:, :2] / jnp.maximum(b_p[:, 2:3], 1e-3)
        unit_k = jnp.asarray([1.0, 1.0, 0.0, 0.0], jnp.float32)
        F_cp = fundamental_from_poses(R_cur, t_cur, R_prev, t_prev, unit_k)
        f_approx = cam_params[0]
        epi = matching.epipolar_mask(
            n_c, n_p, F_cp,
            sigma2[jnp.clip(ff_prev.octave, 0, n_levels - 1)] /
            (f_approx * f_approx))
    mask = epi & cur_unmatched[:, None] & prev_unmatched[None, :] & \
        ff_cur.valid[:, None] & ff_prev.valid[None, :]
    mm = matching.match_nn(ff_cur.desc, ff_prev.desc, mask,
                           max_dist=matching.TH_LOW, nn_ratio=0.9,
                           angles_a=ff_cur.angle, angles_b=ff_prev.angle,
                           check_rotation=True)
    N = ff_cur.xy.shape[0]
    j = jnp.maximum(mm.idx, 0)

    ray_c = cameras.unproject(cam_model, cam_params, ff_cur.xy)
    ray_p = cameras.unproject(cam_model, cam_params, ff_prev.xy[j])
    X = triangulate.triangulate_dlt(
        ray_c, ray_p,
        jnp.broadcast_to(R_cur, (N, 3, 3)), jnp.broadcast_to(t_cur, (N, 3)),
        jnp.broadcast_to(R_prev, (N, 3, 3)), jnp.broadcast_to(t_prev, (N, 3)))

    # gates
    Xc = lie.se3_apply(R_cur, t_cur, X)
    Xp = lie.se3_apply(R_prev, t_prev, X)
    finite = jnp.all(jnp.isfinite(X), axis=-1)
    depth_ok = (Xc[:, 2] > 0) & (Xp[:, 2] > 0)
    # parallax between rays in world frame
    rc_w = jnp.einsum("ji,nj->ni", R_cur, ray_c, precision=_HI)
    rp_w = jnp.einsum("ji,nj->ni", R_prev, ray_p, precision=_HI)
    cosp = jnp.sum(rc_w * rp_w, axis=-1) / (
        jnp.linalg.norm(rc_w, axis=-1) * jnp.linalg.norm(rp_w, axis=-1) + 1e-9)
    parallax_ok = cosp < 0.9998
    e_c = ff_cur.xy - cameras.project(cam_model, cam_params, Xc)
    e_p = ff_prev.xy[j] - cameras.project(cam_model, cam_params, Xp)
    s2c = sigma2[jnp.clip(ff_cur.octave, 0, n_levels - 1)]
    s2p = sigma2[jnp.clip(ff_prev.octave, 0, n_levels - 1)][j]
    reproj_ok = (jnp.sum(e_c ** 2, -1) < 5.991 * s2c) & \
                (jnp.sum(e_p ** 2, -1) < 5.991 * s2p)
    # scale consistency (reference: ratioDist vs ratioOctave within 1.5x)
    Oc = -jnp.einsum("ji,j->i", R_cur, t_cur, precision=_HI)
    Op = -jnp.einsum("ji,j->i", R_prev, t_prev, precision=_HI)
    d_c = jnp.linalg.norm(X - Oc, axis=-1)
    d_p = jnp.linalg.norm(X - Op, axis=-1)
    ratio_dist = d_p / jnp.maximum(d_c, 1e-9)
    ratio_oct = sf[jnp.clip(ff_cur.octave, 0, n_levels - 1)] / \
        sf[jnp.clip(ff_prev.octave, 0, n_levels - 1)][j]
    scale_ok = (ratio_dist < ratio_oct * 1.5) & (ratio_dist * 1.5 > ratio_oct)

    valid = mm.valid & finite & depth_ok & parallax_ok & reproj_ok & scale_ok
    return NewPoints(xyz=X, valid=valid, kp_cur=jnp.arange(N),
                     kp_prev=mm.idx,
                     score=jnp.where(valid, cosp, 2.0))


def select_triangulation_neighbors(m: mapstate.MapState, ki,
                                   n_neighbors: int):
    """Pick triangulation partners for a new keyframe: the temporal
    predecessor + the best covisible keyframes (reference
    CreateNewMapPoints searches <=30 covisible+temporal neighbors,
    src/LocalMapping.cc:413-726).

    Returns (idx (NN,), ok (NN,)); slot 0 is the temporal neighbor.
    """
    K = m.kf_R.shape[0]
    ids = jnp.arange(K)
    before = (ids < ki) & m.kf_valid
    prev = jnp.max(jnp.where(before, ids, -1))
    covis = mapstate.covisibility_weights(m, ki)
    score = jnp.where(before & (ids != prev), covis, 0)
    vals, idxs = jax.lax.top_k(score, n_neighbors - 1)
    idx = jnp.concatenate([jnp.maximum(prev, 0)[None], idxs])
    ok = jnp.concatenate([(prev >= 0)[None], vals > 0])
    return idx, ok


def triangulate_vs_neighbors(m: mapstate.MapState, bank, ki,
                             ff: FeatureFrame, cur_unmatched,
                             nbr_idx, nbr_ok,
                             cam_model: str, cam_params, K4,
                             scale_factor: float, n_levels: int
                             ) -> NewPoints:
    """Triangulate the current KF's unmatched keypoints against each
    neighbor keyframe (features gathered from the device FeatureBank),
    then keep per-keypoint the neighbor with the widest parallax.

    Returns stacked NewPoints with leading dim NN; `valid` already
    deduplicated so each current keypoint creates at most one point.
    """
    from ..slam_map import feature_bank as fb
    R_cur, t_cur = m.kf_R[ki], m.kf_t[ki]

    def one(nbr, ok):
        ffn = fb.frame_view(bank, nbr)
        unb = (bank.kp_pt[nbr] < 0) & ffn.valid
        nps = triangulate_new_points(
            ff, ffn, cur_unmatched, unb,
            R_cur, t_cur, m.kf_R[nbr], m.kf_t[nbr],
            cam_model, cam_params, K4, scale_factor, n_levels)
        return nps._replace(valid=nps.valid & ok,
                            score=jnp.where(nps.valid & ok, nps.score, 2.0))

    nps = jax.vmap(one)(nbr_idx, nbr_ok)
    best = jnp.argmin(nps.score, axis=0)              # (N,) winning neighbor
    NN = nbr_idx.shape[0]
    winner = (jnp.arange(NN)[:, None] == best[None, :]) & nps.valid
    return nps._replace(valid=winner)


def point_descriptor_stats(X, desc, kf_center, octave, scale_factor: float,
                           n_levels: int):
    """Normal + scale range for freshly created points (reference
    MapPoint::UpdateNormalAndDepth, src/MapPoint.cc:440)."""
    sf = scale_factor ** jnp.clip(octave, 0, n_levels - 1).astype(jnp.float32)
    view = X - kf_center
    dist = jnp.linalg.norm(view, axis=-1)
    normal = view / jnp.maximum(dist, 1e-9)[:, None]
    max_dist = dist * sf
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return normal, min_dist, max_dist


def _compact(mask: jnp.ndarray, cap: int, score=None):
    """Select up to `cap` True positions: returns (sel (cap,), sel_valid
    (cap,), inv (n,) mapping global->local or -1).  With `score`, True
    positions are taken best-score-first (the reference's sorted point
    budget, src/Optimizer.cc:4277-4295, with observation count standing
    in for stored reprojection error)."""
    n = mask.shape[0]
    if score is None:
        order = jnp.argsort(~mask)      # True entries first, stable
    else:
        order = jnp.argsort(jnp.where(mask, -score.astype(jnp.float32),
                                      jnp.inf))
    sel = order[:cap]
    if cap > n:
        # capacity exceeds the candidate pool (bank-slab sources can be
        # smaller than the obs capacity): pad with index 0, masked below
        sel = jnp.pad(sel, (0, cap - n))
    count = jnp.sum(mask.astype(jnp.int32))
    sel_valid = jnp.arange(cap) < count
    inv = jnp.full(n, -1, jnp.int32).at[jnp.where(sel_valid, sel, n)].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop")
    return sel, sel_valid, inv


def gather_window_problem(m: mapstate.MapState, center_kf: jnp.ndarray,
                          window: int, n_levels: int, scale_factor: float,
                          cap_cams: int = 32, cap_pts: int = 8192,
                          cap_obs: int = 32768,
                          window_mode: str = "covis",
                          min_anchors: int = 2,
                          prior_pos=None, prior_w=None):
    """Compact the local-BA problem into fixed small capacities
    (reference LocalBundleAdjustment window construction,
    src/Optimizer.cc:1069-1140: the window is the current KF + its best
    covisible KFs, free; other observers fixed; points budgeted by a
    sorted selection).

    The window is covisibility-selected (top `window-1` covisible KFs of
    the center + the temporal predecessor as a floor), matching the
    reference's GetBestCovisibilityKeyFrames window rather than a
    temporal id range.

    Returns (BAProblem, cam_sel, pt_sel) for scattering results back.
    """
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))

    kf_ids = jnp.arange(K)
    if window_mode == "temporal":
        # LocalInertialBA keeps a temporal chain (reference
        # src/Optimizer.cc:2452-2460) so the preintegration factor chain
        # stays inside the free window
        in_window = (kf_ids > center_kf - window) & \
            (kf_ids <= center_kf) & m.kf_valid
    else:
        covis = mapstate.covisibility_weights(m, center_kf)
        cscore = jnp.where(m.kf_valid & (kf_ids != center_kf), covis, 0)
        top_vals, top_idx = jax.lax.top_k(cscore, max(window - 1, 1))
        prev = jnp.max(jnp.where((kf_ids < center_kf) & m.kf_valid,
                                 kf_ids, -1))
        in_window = jnp.zeros(K, bool).at[top_idx].set(top_vals > 0)
        in_window = in_window.at[center_kf].set(True)
        in_window = in_window.at[jnp.maximum(prev, 0)].set(
            in_window[jnp.maximum(prev, 0)] | (prev >= 0))
        in_window &= m.kf_valid

    obs_pt_c = jnp.clip(m.obs_pt, 0, P - 1)
    obs_kf_c = jnp.clip(m.obs_kf, 0, K - 1)
    obs_ok = m.obs_valid & m.pt_valid[obs_pt_c] & m.kf_valid[obs_kf_c]

    # points observed by the window, budgeted by observation count when
    # over capacity (stand-in for the reference's sorted-reproj budget)
    pt_in = jnp.zeros(P, bool).at[obs_pt_c].max(obs_ok & in_window[obs_kf_c])
    nobs = jnp.zeros(P, jnp.int32).at[obs_pt_c].add(obs_ok.astype(jnp.int32))
    pt_sel, pt_sel_valid, pt_inv = _compact(pt_in, cap_pts, score=nobs)

    # observations of those points (from any KF)
    obs_rel = obs_ok & (pt_inv[obs_pt_c] >= 0)
    # cameras touched: window cams free; outside observers fixed.
    # In-window cams MUST survive the capacity cut (an unscored compact
    # keeps lowest indices — the OLDEST cams — and once window points are
    # co-observed by >cap_cams older KFs the live window itself fell out
    # of the problem: factors remapped invalid, every kept cam fixed,
    # and the window BA silently became a no-op while tracking drifted);
    # outside anchors fill the rest best-connected-first
    cam_nobs = jnp.zeros(K, jnp.int32).at[obs_kf_c].add(
        obs_rel.astype(jnp.int32))
    cam_touched = (cam_nobs > 0) | in_window
    cam_score = cam_nobs.astype(jnp.float32) + \
        jnp.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams,
                                               score=cam_score)
    obs_rel &= cam_inv[obs_kf_c] >= 0
    obs_sel, obs_sel_valid, _ = _compact(obs_rel, cap_obs)

    o_kf = cam_inv[obs_kf_c[obs_sel]]
    o_pt = pt_inv[obs_pt_c[obs_sel]]
    inv_sigma2 = 1.0 / sf[jnp.clip(m.obs_octave[obs_sel], 0,
                                   n_levels - 1)] ** 2
    # gauge: KF0 always fixed; everything outside the window is an anchor.
    # (the init-map GBA window covers KFs {0,1}: KF0 pins the frame, the
    # median-depth normalization pins scale before BA — matching the
    # reference's CreateInitialMapMonocular, src/Tracking.cc:642-768.)
    # With >= 3 cameras and no out-of-window anchors the mono scale gauge
    # is free and LM can slide it; pin KF1 as well in that case.
    fixed = ~in_window[cam_sel] | (cam_sel < 1)
    n_prob_cams = jnp.sum(cam_sel_valid.astype(jnp.int32))
    n_anchors = jnp.sum((fixed & cam_sel_valid).astype(jnp.int32))
    # mono-visual BA needs a second anchor to pin scale; VI callers pass
    # min_anchors=1 (the IMU observes scale — pinning a second KF there
    # would fight the metric solution, reference FullInertialBA fixes only
    # the init KF, src/Optimizer.cc:430)
    need_second = (n_anchors < min_anchors) & (n_prob_cams >= 3)
    fixed = fixed | ((cam_sel == 1) & need_second)
    prob = ba.BAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=fixed, cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        obs_cam=jnp.maximum(o_kf, 0), obs_pt=jnp.maximum(o_pt, 0),
        obs_uv=m.obs_uv[obs_sel], obs_inv_sigma2=inv_sigma2,
        obs_valid=obs_sel_valid & (o_kf >= 0) & (o_pt >= 0),
        obs_ur=m.obs_ur[obs_sel])
    if prior_pos is not None:
        prob = prob._replace(prior_pos=prior_pos[cam_sel],
                             prior_w=prior_w[cam_sel])
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_problem_bank(m: mapstate.MapState, bank, center_kf,
                               window: int, n_levels: int,
                               scale_factor: float,
                               cap_cams: int = 32, cap_pts: int = 8192,
                               cap_obs: int = 32768,
                               window_mode: str = "covis",
                               min_anchors: int = 2,
                               prior_pos=None, prior_w=None):
    """COO window problem from the per-KF FeatureBank slabs — the bank
    analogue of gather_window_problem, for the solvers that need a COO
    observation list (VI BA, GNSS-prior BA, distributed BA) rather than
    the dense grid.  Replaces the O(map obs capacity) scans with
    (C, N)-slab gathers and incidence-mask matvecs — same window/anchor/budget semantics.
    """
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))

    kf_ids = jnp.arange(K)
    if window_mode == "temporal":
        in_window = (kf_ids > center_kf - window) & \
            (kf_ids <= center_kf) & m.kf_valid
    else:
        covis = mapstate.covisibility_weights(m, center_kf)
        cscore = jnp.where(m.kf_valid & (kf_ids != center_kf), covis, 0)
        top_vals, top_idx = jax.lax.top_k(cscore, max(window - 1, 1))
        prev = jnp.max(jnp.where((kf_ids < center_kf) & m.kf_valid,
                                 kf_ids, -1))
        in_window = jnp.zeros(K, bool).at[top_idx].set(top_vals > 0)
        in_window = in_window.at[center_kf].set(True)
        in_window = in_window.at[jnp.maximum(prev, 0)].set(
            in_window[jnp.maximum(prev, 0)] | (prev >= 0))
        in_window &= m.kf_valid

    live = mapstate.live_incidence(m).astype(jnp.float32)
    nobs_win = jnp.einsum("pk,k->p", live, in_window.astype(jnp.float32),
                          precision=_HI)
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts,
                                            score=nobs_win)

    sel_mask = jnp.zeros(P, jnp.float32).at[
        jnp.where(pt_sel_valid, pt_sel, P)].set(1.0, mode="drop")
    cam_obs_sel = jnp.einsum("pk,p->k", live, sel_mask, precision=_HI)
    cam_touched = ((cam_obs_sel > 0) | in_window) & m.kf_valid
    # in-window cams first (see gather_window_problem: an unscored
    # compact drops the live window once >cap_cams cams are touched),
    # then best-connected anchors
    cam_score = cam_obs_sel + jnp.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams,
                                               score=cam_score)

    # observation rows = the selected cameras' slabs, compacted to cap_obs
    C = cam_sel.shape[0]
    kpt = bank.kp_pt[cam_sel]                            # (C, N)
    kpt_c = jnp.clip(kpt, 0, P - 1)
    gp = pt_inv[kpt_c]
    ok = (bank.valid[cam_sel] & (kpt >= 0) & m.pt_valid[kpt_c] &
          (gp >= 0) & cam_sel_valid[:, None]).reshape(-1)
    obs_sel, obs_sel_valid, _ = _compact(ok, cap_obs)
    o_kf = jnp.broadcast_to(jnp.arange(C)[:, None],
                            kpt.shape).reshape(-1)[obs_sel]
    o_pt = gp.reshape(-1)[obs_sel]
    inv_sigma2 = 1.0 / sf[jnp.clip(
        bank.octave[cam_sel].reshape(-1)[obs_sel], 0, n_levels - 1)] ** 2

    fixed = ~in_window[cam_sel] | (cam_sel < 1)
    n_prob_cams = jnp.sum(cam_sel_valid.astype(jnp.int32))
    n_anchors = jnp.sum((fixed & cam_sel_valid).astype(jnp.int32))
    need_second = (n_anchors < min_anchors) & (n_prob_cams >= 3)
    fixed = fixed | ((cam_sel == 1) & need_second)
    prob = ba.BAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=fixed, cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        obs_cam=jnp.maximum(o_kf, 0), obs_pt=jnp.maximum(o_pt, 0),
        obs_uv=bank.xy[cam_sel].reshape(-1, 2)[obs_sel],
        obs_inv_sigma2=inv_sigma2,
        obs_valid=obs_sel_valid & (o_pt >= 0),
        obs_ur=bank.ur[cam_sel].reshape(-1)[obs_sel])
    if prior_pos is not None:
        prob = prob._replace(prior_pos=prior_pos[cam_sel],
                             prior_w=prior_w[cam_sel])
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_grid(m: mapstate.MapState, center_kf: jnp.ndarray,
                       window: int, n_levels: int, scale_factor: float,
                       cap_cams: int = 16, cap_pts: int = 4096,
                       window_mode: str = "covis", min_anchors: int = 2):
    """Window selection into a dense (cap_pts, cap_cams) observation grid
    (ba_grid.GridBAProblem) — a point is observed at most once per KF, so
    the window problem needs no COO list.  Three map-sized index ops
    total (two segment reductions + ONE packed scatter), vs the COO
    path's compaction sorts plus per-field gathers.

    Same window/anchor semantics as gather_window_problem (reference
    LocalBundleAdjustment window, src/Optimizer.cc:1069-1140).
    """
    from ..solver import ba_grid
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))

    kf_ids = jnp.arange(K)
    if window_mode == "temporal":
        in_window = (kf_ids > center_kf - window) & \
            (kf_ids <= center_kf) & m.kf_valid
    else:
        covis = mapstate.covisibility_weights(m, center_kf)
        cscore = jnp.where(m.kf_valid & (kf_ids != center_kf), covis, 0)
        top_vals, top_idx = jax.lax.top_k(cscore, max(window - 1, 1))
        prev = jnp.max(jnp.where((kf_ids < center_kf) & m.kf_valid,
                                 kf_ids, -1))
        in_window = jnp.zeros(K, bool).at[top_idx].set(top_vals > 0)
        in_window = in_window.at[center_kf].set(True)
        in_window = in_window.at[jnp.maximum(prev, 0)].set(
            in_window[jnp.maximum(prev, 0)] | (prev >= 0))
        in_window &= m.kf_valid

    obs_pt_c = jnp.clip(m.obs_pt, 0, P - 1)
    obs_kf_c = jnp.clip(m.obs_kf, 0, K - 1)
    obs_ok = m.obs_valid & m.pt_valid[obs_pt_c] & m.kf_valid[obs_kf_c]

    # in-window observation count per point: selection flag AND budget
    # score in one segment-sum (points with more window observers first)
    nobs_win = jnp.zeros(P, jnp.int32).at[obs_pt_c].add(
        (obs_ok & in_window[obs_kf_c]).astype(jnp.int32))
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts,
                                            score=nobs_win)

    obs_rel = obs_ok & (pt_inv[obs_pt_c] >= 0)
    # in-window cams first (see gather_window_problem: an unscored
    # compact drops the live window once >cap_cams cams are touched),
    # then best-connected anchors
    cam_nobs = jnp.zeros(K, jnp.int32).at[obs_kf_c].add(
        obs_rel.astype(jnp.int32))
    cam_touched = (cam_nobs > 0) | in_window
    cam_score = cam_nobs.astype(jnp.float32) + \
        jnp.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams,
                                               score=cam_score)

    # ONE packed scatter builds the grid: [u, v, inv_sigma2, ur, flag]
    gp = pt_inv[obs_pt_c]
    gk = cam_inv[obs_kf_c]
    ok = obs_rel & (gk >= 0)
    inv_sigma2 = 1.0 / sf[jnp.clip(m.obs_octave, 0, n_levels - 1)] ** 2
    payload = jnp.concatenate([
        m.obs_uv, inv_sigma2[:, None], m.obs_ur[:, None],
        jnp.ones_like(inv_sigma2)[:, None]], axis=1)
    grid = jnp.zeros((cap_pts, cap_cams, 5), jnp.float32).at[
        jnp.where(ok, gp, cap_pts), jnp.maximum(gk, 0)].set(
        payload, mode="drop")

    fixed = ~in_window[cam_sel] | (cam_sel < 1)
    n_prob_cams = jnp.sum(cam_sel_valid.astype(jnp.int32))
    n_anchors = jnp.sum((fixed & cam_sel_valid).astype(jnp.int32))
    need_second = (n_anchors < min_anchors) & (n_prob_cams >= 3)
    fixed = fixed | ((cam_sel == 1) & need_second)

    prob = ba_grid.GridBAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=fixed, cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        uv=grid[:, :, 0:2], inv_sigma2=grid[:, :, 2],
        valid=grid[:, :, 4] > 0, ur=jnp.where(grid[:, :, 4] > 0,
                                              grid[:, :, 3], -1.0))
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def gather_window_grid_bank(m: mapstate.MapState, bank, center_kf,
                            window: int, n_levels: int, scale_factor: float,
                            cam_model: str = "pinhole", cam_params=None,
                            cap_cams: int = 16, cap_pts: int = 4096,
                            window_mode: str = "covis",
                            min_anchors: int = 2):
    """Window selection into the dense grid, sourcing observations from
    the per-KF FeatureBank slabs instead of the map-capacity COO list.

    Same window/anchor/budget semantics as gather_window_grid, different
    data path: the COO gather scans O(map obs capacity) rows (map-sized
    gather/scatter fusions — a fixed cost of every local BA), while the bank path touches only the
    selected cameras' (C, N) slabs (~19k rows at C=16, N=1200) plus
    elementwise work on the (P, K) incidence mask.  The bank's bindings
    mirror the live observation set (System keeps them current through
    insert/fuse/compact), so the gathered problem is the same.
    """
    from ..solver import ba_grid
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    sf = jnp.asarray(scale_factor ** jnp.arange(n_levels, dtype=jnp.float32))

    kf_ids = jnp.arange(K)
    if window_mode == "temporal":
        in_window = (kf_ids > center_kf - window) & \
            (kf_ids <= center_kf) & m.kf_valid
    else:
        covis = mapstate.covisibility_weights(m, center_kf)
        cscore = jnp.where(m.kf_valid & (kf_ids != center_kf), covis, 0)
        top_vals, top_idx = jax.lax.top_k(cscore, max(window - 1, 1))
        prev = jnp.max(jnp.where((kf_ids < center_kf) & m.kf_valid,
                                 kf_ids, -1))
        in_window = jnp.zeros(K, bool).at[top_idx].set(top_vals > 0)
        in_window = in_window.at[center_kf].set(True)
        in_window = in_window.at[jnp.maximum(prev, 0)].set(
            in_window[jnp.maximum(prev, 0)] | (prev >= 0))
        in_window &= m.kf_valid

    # point budget: in-window observer count selects candidates (one
    # incidence matvec, no O(obs) scan) ...
    live = mapstate.live_incidence(m).astype(jnp.float32)
    nobs_win = jnp.einsum("pk,k->p", live, in_window.astype(jnp.float32),
                          precision=_HI)
    # ... and when the cap binds, points are taken LOWEST current
    # reprojection error first (reference
    # KeyFrame::GetSortedReprojectionErrorIndices, src/KeyFrame.cc:424,
    # consumed by ComputeAndFillLocalMapPoints, src/Optimizer.cc:4277-
    # 4295) — "best-measured", not "most-observed".  Errors come from the
    # window KFs' bank slabs: (W, N) projections, a scatter-min, nothing
    # map-sized.
    if window_mode == "temporal":
        win_idx = jnp.clip(center_kf - jnp.arange(window), 0, K - 1)
    else:
        win_idx = jnp.concatenate([
            center_kf[None], jnp.maximum(prev, 0)[None], top_idx])
    win_ok = in_window[win_idx]
    wpt = bank.kp_pt[win_idx]                            # (W, N)
    wpt_c = jnp.clip(wpt, 0, P - 1)
    Xw = m.pt_xyz[wpt_c]                                 # (W, N, 3)
    Xc = jnp.einsum("wab,wnb->wna", m.kf_R[win_idx], Xw,
                    precision=_HI) + m.kf_t[win_idx][:, None]
    uvp = cameras.project(cam_model, cam_params,
                          Xc.reshape(-1, 3)).reshape(Xc.shape[0],
                                                     Xc.shape[1], 2)
    err = jnp.linalg.norm(bank.xy[win_idx] - uvp, axis=-1)
    row_ok = bank.valid[win_idx] & (wpt >= 0) & m.pt_valid[wpt_c] & \
        win_ok[:, None] & (Xc[..., 2] > 1e-3)
    BIG = 1e6
    pt_err = jnp.full(P + 1, BIG).at[
        jnp.where(row_ok, wpt_c, P)].min(jnp.minimum(err, BIG - 1.0),
                                         mode="drop")[:P]
    pt_sel, pt_sel_valid, pt_inv = _compact(nobs_win > 0, cap_pts,
                                            score=-pt_err)

    # cameras: window KFs free + out-of-window observers of selected
    # points as fixed anchors — one incidence matvec
    sel_mask = jnp.zeros(P, jnp.float32).at[
        jnp.where(pt_sel_valid, pt_sel, P)].set(1.0, mode="drop")
    cam_obs_sel = jnp.einsum("pk,p->k", live, sel_mask, precision=_HI)
    cam_touched = ((cam_obs_sel > 0) | in_window) & m.kf_valid
    # in-window cams first (see gather_window_problem: an unscored
    # compact drops the live window once >cap_cams cams are touched),
    # then best-connected anchors
    cam_score = cam_obs_sel + jnp.where(in_window, 1e6, 0.0)
    cam_sel, cam_sel_valid, cam_inv = _compact(cam_touched, cap_cams,
                                               score=cam_score)

    # observations: the selected cameras' bank slabs, (C, N) rows total
    kpt = bank.kp_pt[cam_sel]                         # (C, N)
    kpt_c = jnp.clip(kpt, 0, P - 1)
    gp = pt_inv[kpt_c]                                # (C, N) local pt id
    ok = bank.valid[cam_sel] & (kpt >= 0) & m.pt_valid[kpt_c] & \
        (gp >= 0) & cam_sel_valid[:, None]
    inv_sigma2 = 1.0 / sf[jnp.clip(bank.octave[cam_sel], 0,
                                   n_levels - 1)] ** 2
    payload = jnp.concatenate([
        bank.xy[cam_sel], inv_sigma2[..., None],
        bank.ur[cam_sel][..., None],
        jnp.ones_like(inv_sigma2)[..., None]], axis=-1)   # (C, N, 5)
    C = cam_sel.shape[0]
    grid = jnp.zeros((cap_pts, cap_cams, 5), jnp.float32).at[
        jnp.where(ok, gp, cap_pts),
        jnp.broadcast_to(jnp.arange(C)[:, None], ok.shape)].set(
        payload, mode="drop")

    fixed = ~in_window[cam_sel] | (cam_sel < 1)
    n_prob_cams = jnp.sum(cam_sel_valid.astype(jnp.int32))
    n_anchors = jnp.sum((fixed & cam_sel_valid).astype(jnp.int32))
    need_second = (n_anchors < min_anchors) & (n_prob_cams >= 3)
    fixed = fixed | ((cam_sel == 1) & need_second)

    prob = ba_grid.GridBAProblem(
        R=m.kf_R[cam_sel], t=m.kf_t[cam_sel],
        cam_fixed=fixed, cam_valid=cam_sel_valid,
        X=m.pt_xyz[pt_sel], pt_valid=pt_sel_valid & m.pt_valid[pt_sel],
        uv=grid[:, :, 0:2], inv_sigma2=grid[:, :, 2],
        valid=grid[:, :, 4] > 0, ur=jnp.where(grid[:, :, 4] > 0,
                                              grid[:, :, 3], -1.0))
    return prob, cam_sel, cam_sel_valid, pt_sel, prob.pt_valid


def run_local_ba(m: mapstate.MapState, center_kf: jnp.ndarray,
                 cam_model: str, cam_params,
                 window: int = 8, iterations: int = 10,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 chi2_cull: float = 7.5,
                 stereo_bf: float = 0.0,
                 mesh=None, mesh_axis: str = "shard",
                 prior_pos=None, prior_w=None,
                 pcg_iters: int = 32,
                 schur_solver: str = "auto",
                 bank=None,
                 **caps):
    """Local BA on a covisibility keyframe window + outlier observation
    culling (reference LocalBundleAdjustment, 10 its, then removes
    chi2>5.991 observations; we cull at a slightly looser threshold and
    rely on the robust kernel in between).

    With `mesh`, the solve runs sharded over the device mesh (points +
    observations partitioned, reduced system psum'd) via
    parallel.dist_ba — the engine's distributed back-end, not a demo.
    """
    cap_cams = caps.get("cap_cams", 32)
    window_mode = caps.pop("window_mode", "covis")
    if schur_solver == "auto":
        # window-sized problems: the dense (P, K) grid formulation (no
        # scatters/gathers in the LM loop, direct block-Cholesky Schur
        # solve) beats both the PCG chain and the COO dense solve
        schur_solver = "grid" if (mesh is None and prior_pos is None and
                                  cap_cams <= 32) else "pcg"
    if schur_solver == "grid":
        from ..solver import ba_grid
        if bank is not None:
            # per-KF slab gather (no O(obs-capacity) scans)
            gprob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_grid_bank(
                m, bank, center_kf, window, n_levels, scale_factor,
                cam_model=cam_model, cam_params=cam_params,
                cap_cams=cap_cams, cap_pts=caps.get("cap_pts", 8192))
        else:
            gprob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_grid(
                m, center_kf, window, n_levels, scale_factor,
                cap_cams=cap_cams, cap_pts=caps.get("cap_pts", 8192))
        R_g, t_g, X_g, _ = ba_grid.bundle_adjust_grid(
            gprob, cam_model, cam_params, iterations=iterations,
            stereo_bf=stereo_bf)
        res = ba.BAResult(R=R_g, t=t_g, X=X_g,
                          obs_chi2=jnp.zeros(()), cost=jnp.zeros(()))
        prob = gprob
    else:
        if bank is not None:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = \
                gather_window_problem_bank(
                    m, bank, center_kf, window, n_levels, scale_factor,
                    window_mode=window_mode,
                    prior_pos=prior_pos, prior_w=prior_w, **caps)
        else:
            prob, cam_sel, cam_ok, pt_sel, pt_ok = gather_window_problem(
                m, center_kf, window, n_levels, scale_factor,
                window_mode=window_mode,
                prior_pos=prior_pos, prior_w=prior_w, **caps)
        if mesh is not None:
            from ..parallel import dist_ba
            dprob = dist_ba.partition_problem(prob, mesh.shape[mesh_axis])
            R_d, t_d, X_d, _ = dist_ba.dist_bundle_adjust(
                dprob, mesh, axis=mesh_axis, cam_model=cam_model,
                cam_params=cam_params, iterations=iterations)
            res = ba.BAResult(R=R_d, t=t_d, X=X_d,
                              obs_chi2=jnp.zeros_like(prob.obs_inv_sigma2),
                              cost=jnp.zeros(()))
        else:
            res = ba.bundle_adjust(prob, cam_model, cam_params,
                                   iterations=iterations,
                                   stereo_bf=stereo_bf,
                                   pcg_iters=pcg_iters,
                                   schur_solver=schur_solver)
    # scatter back optimized cameras/points
    K = m.kf_R.shape[0]
    P = m.pt_xyz.shape[0]
    free = cam_ok & ~prob.cam_fixed
    cam_dst = jnp.where(free, cam_sel, K)
    kf_R = m.kf_R.at[cam_dst].set(
        jnp.where(free[:, None, None], res.R, m.kf_R[jnp.clip(cam_dst, 0, K - 1)]),
        mode="drop")
    kf_t = m.kf_t.at[cam_dst].set(
        jnp.where(free[:, None], res.t, m.kf_t[jnp.clip(cam_dst, 0, K - 1)]),
        mode="drop")
    pt_dst = jnp.where(pt_ok, pt_sel, P)
    pt_xyz = m.pt_xyz.at[pt_dst].set(
        jnp.where(pt_ok[:, None], res.X, m.pt_xyz[jnp.clip(pt_dst, 0, P - 1)]),
        mode="drop")
    return m._replace(kf_R=kf_R, kf_t=kf_t, pt_xyz=pt_xyz)

"""Stereo matching: left-right ORB association on rectified pairs.

Parity target: upstream Frame::ComputeStereoMatches (stereo path is dead
code in the fork but required by the build's stereo configs): for each
left keypoint, search the same rectified row (band of +-2 px scaled by
octave) within the disparity range, best Hamming descriptor wins, giving
per-keypoint right-coordinate uR and depth = fx * baseline / disparity.

Design: one masked Hamming NN over all left x right pairs — the row
band, disparity range, and octave gates are just mask terms.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import matching


class StereoDepth(NamedTuple):
    ur: jnp.ndarray      # (N,) right-image u coordinate (-1 if none)
    depth: jnp.ndarray   # (N,) metric depth (0 if none)
    valid: jnp.ndarray   # (N,) bool


def stereo_match(ff_l, ff_r, fx: float, baseline: float,
                 row_tol: float = 2.0,
                 min_depth: float = 0.1, max_depth: float = 40.0,
                 scale_factor: float = 1.2) -> StereoDepth:
    """Associate left keypoints with right keypoints on a rectified pair."""
    min_disp = fx * baseline / max_depth
    max_disp = fx * baseline / min_depth
    du = ff_l.xy[:, None, 0] - ff_r.xy[None, :, 0]   # disparity candidates
    dv = jnp.abs(ff_l.xy[:, None, 1] - ff_r.xy[None, :, 1])
    tol = row_tol * scale_factor ** ff_l.octave.astype(jnp.float32)
    mask = (dv <= tol[:, None]) & (du >= min_disp) & (du <= max_disp)
    mask &= ff_l.valid[:, None] & ff_r.valid[None, :]
    oct_ok = jnp.abs(ff_l.octave[:, None] - ff_r.octave[None, :]) <= 1
    mask &= oct_ok
    mm = matching.match_nn(ff_l.desc, ff_r.desc, mask,
                           max_dist=matching.TH_HIGH, nn_ratio=0.9)
    j = jnp.maximum(mm.idx, 0)
    ur = ff_r.xy[j, 0]
    disp = jnp.clip(ff_l.xy[:, 0] - ur, 1e-3, None)
    depth = fx * baseline / disp
    ok = mm.valid & (depth > min_depth) & (depth < max_depth)
    return StereoDepth(ur=jnp.where(ok, ur, -1.0),
                       depth=jnp.where(ok, depth, 0.0), valid=ok)


class FisheyeStereo(NamedTuple):
    """Direct fisheye-pair triangulation output (left-camera frame)."""
    X: jnp.ndarray       # (N, 3) triangulated point per LEFT keypoint
    depth: jnp.ndarray   # (N,) left-camera z (0 if none)
    ridx: jnp.ndarray    # (N,) matched right keypoint index (-1 none)
    valid: jnp.ndarray   # (N,) bool


def fisheye_stereo_match(ff_l, ff_r, params_l, params_r, R_rl, t_rl,
                         epipolar_th: float = 6e-3,
                         min_depth: float = 0.1, max_depth: float = 40.0,
                         max_parallax_cos: float = 0.9998,
                         reproj_chi2: float = 5.991,
                         scale_factor: float = 1.2,
                         cam_model: str = "kb8") -> FisheyeStereo:
    """Direct RAW-fisheye stereo: descriptor matching gated by the
    bearing-space epipolar constraint, then ray-pair triangulation with
    the factory extrinsic (reference KannalaBrandt8::TriangulateMatches,
    /root/reference/src/CameraModels/KannalaBrandt8.cpp:219,306 — the
    upstream path for NON-rectified KB8 rigs).  Unlike the rectified
    pipeline (config.tumvi_stereo_inertial), no virtual-pinhole FOV crop
    is applied, so the fisheye periphery the reference keeps survives.

    Acceptance mirrors the reference's checks: epipolar residual, ray
    parallax (cosParallaxRays < 0.9998), positive depth in BOTH cameras,
    and reprojection chi2 in BOTH images against the octave noise model.

    R_rl, t_rl: right <- left camera transform (x_r = R_rl x_l + t_rl).

    Scope: the FORWARD hemisphere (bearing z > ~0.05, polar angle up to
    ~87 deg off-axis).  The inhomogeneous DLT normalizes rays by z, so
    the band a >=180-deg lens sees BEYOND 90 deg cannot triangulate
    here (it would need the homogeneous SVD path); such bearings are
    masked out of the match rather than fed to a division by ~0.  The
    rectified pipeline's crop is ~45-55 deg, so the direct path still
    recovers a wide periphery band the crop discards.
    """
    from ..ops import cameras, lie, triangulate

    b_l = cameras.unproject(cam_model, params_l, ff_l.xy)
    b_r = cameras.unproject(cam_model, params_r, ff_r.xy)
    b_l = b_l / jnp.maximum(jnp.linalg.norm(b_l, axis=-1, keepdims=True),
                            1e-9)
    b_r = b_r / jnp.maximum(jnp.linalg.norm(b_r, axis=-1, keepdims=True),
                            1e-9)
    # essential-matrix epipolar gate on unit bearings
    E = jnp.matmul(lie.hat(t_rl), R_rl,
                   precision=jax.lax.Precision.HIGHEST)
    Ebl = jnp.einsum("ij,nj->ni", E, b_l,
                     precision=jax.lax.Precision.HIGHEST)
    res = jnp.abs(jnp.einsum("mi,ni->nm", b_r, Ebl,
                             precision=jax.lax.Precision.HIGHEST))
    # forward-hemisphere gate (see docstring): z-normalized DLT rows
    # blow up as bearing z -> 0, so exclude near/behind-90-deg bearings
    # from matching instead of producing inf/NaN triangulations
    fwd = (b_l[:, None, 2] > 0.05) & (b_r[None, :, 2] > 0.05)
    mask = fwd & (res < epipolar_th) & \
        ff_l.valid[:, None] & ff_r.valid[None, :]
    mask &= jnp.abs(ff_l.octave[:, None] - ff_r.octave[None, :]) <= 1
    mm = matching.match_nn(ff_l.desc, ff_r.desc, mask,
                           max_dist=matching.TH_HIGH, nn_ratio=0.9)
    j = jnp.maximum(mm.idx, 0)
    br_m = b_r[j]
    # parallax: rotate the right bearing into the left frame
    br_in_l = jnp.einsum("ji,nj->ni", R_rl, br_m,
                         precision=jax.lax.Precision.HIGHEST)
    cos_par = jnp.sum(b_l * br_in_l, axis=-1)
    # triangulate: left cam at identity, right cam at (R_rl, t_rl)
    X = triangulate.triangulate_dlt(
        b_l, br_m, jnp.eye(3), jnp.zeros(3), R_rl, t_rl)
    z_l = X[:, 2]
    Xr = jnp.einsum("ij,nj->ni", R_rl, X,
                    precision=jax.lax.Precision.HIGHEST) + t_rl
    # reprojection chi2 in both images (octave noise model)
    uv_l = cameras.project(cam_model, params_l, X)
    uv_r = cameras.project(cam_model, params_r, Xr)
    s2 = scale_factor ** (2.0 * ff_l.octave.astype(jnp.float32))
    e_l = jnp.sum((uv_l - ff_l.xy) ** 2, axis=-1) / s2
    e_r = jnp.sum((uv_r - ff_r.xy[j]) ** 2, axis=-1) / s2
    ok = mm.valid & (cos_par < max_parallax_cos) & \
        (z_l > min_depth) & (z_l < max_depth) & (Xr[:, 2] > 0) & \
        (e_l < reproj_chi2) & (e_r < reproj_chi2)
    return FisheyeStereo(
        X=jnp.where(ok[:, None], X, 0.0),
        depth=jnp.where(ok, z_l, 0.0),
        ridx=jnp.where(ok, jnp.maximum(mm.idx, 0), -1),
        valid=ok)


def refine_disparity(img_l: jnp.ndarray, img_r: jnp.ndarray,
                     xy_l: jnp.ndarray, d: StereoDepth,
                     fx: float, baseline: float,
                     w: int = 5, r_search: int = 2) -> StereoDepth:
    """Subpixel correlation refinement of the matched right-u.

    Parity target: the SAD sweep + parabola fit in upstream
    Frame::ComputeStereoMatches (integer keypoint coordinates quantize
    disparity to +-0.5 px — at a 5 px disparity that is a +-10% depth
    error per observation).  For each valid match, compare the
    (2w+1)^2 left patch against right patches shifted by
    [-r_search, r_search] around the matched uR, fit a parabola through
    the SAD minimum and its neighbors, and re-derive uR/depth.

    Gathers are batched dynamic slices; with w=5, r=2 the data volume
    is tiny (N x 11 x 15).
    """
    h, wid = img_l.shape
    s = 2 * w + 1
    sw = s + 2 * r_search
    x_l = jnp.round(xy_l[:, 0]).astype(jnp.int32)
    y = jnp.clip(jnp.round(xy_l[:, 1]).astype(jnp.int32) - w, 0, h - s)
    xl0 = jnp.clip(x_l - w, 0, wid - s)
    ur_i = jnp.round(d.ur).astype(jnp.int32)
    xr0 = jnp.clip(ur_i - w - r_search, 0, wid - sw)

    def slice_l(yy, xx):
        return jax.lax.dynamic_slice(img_l, (yy, xx), (s, s))

    def slice_r(yy, xx):
        return jax.lax.dynamic_slice(img_r, (yy, xx), (s, sw))

    Pl = jax.vmap(slice_l)(y, xl0)                     # (N, s, s)
    Pr = jax.vmap(slice_r)(y, xr0)                     # (N, s, sw)
    # SSD at each shift (the reference sweeps SAD; SSD of a bilinearly
    # shifted signal is locally QUADRATIC in the shift, so the parabola
    # vertex is unbiased — SAD's V-shaped cost biases it by ~0.2 px)
    sads = jnp.stack([
        jnp.sum(jnp.square(Pr[:, :, k:k + s] - Pl), axis=(1, 2))
        for k in range(2 * r_search + 1)], axis=1)     # (N, 2r+1)
    best = jnp.argmin(sads, axis=1)
    bc = jnp.clip(best, 1, 2 * r_search - 1)           # parabola needs both
    c0 = jnp.take_along_axis(sads, (bc - 1)[:, None], 1)[:, 0]
    c1 = jnp.take_along_axis(sads, bc[:, None], 1)[:, 0]
    c2 = jnp.take_along_axis(sads, (bc + 1)[:, None], 1)[:, 0]
    denom = c0 + c2 - 2 * c1
    frac = jnp.where(jnp.abs(denom) > 1e-6,
                     0.5 * (c0 - c2) / jnp.maximum(denom, 1e-6), 0.0)
    frac = jnp.clip(frac, -1.0, 1.0)
    # refined right-u: integer window start + best shift + subpixel
    ur_new = (xr0 + bc + frac).astype(jnp.float32) + w
    # reject refinements that moved too far or hit the sweep edge
    moved_ok = (jnp.abs(ur_new - d.ur) <= r_search + 1.0) & \
        (best == bc)
    ur = jnp.where(d.valid & moved_ok, ur_new, d.ur)
    disp = jnp.clip(xy_l[:, 0] - ur, 1e-3, None)
    depth = jnp.where(d.valid, fx * baseline / disp, 0.0)
    return StereoDepth(ur=jnp.where(d.valid, ur, -1.0), depth=depth,
                       valid=d.valid)

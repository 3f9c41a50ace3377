"""Cross-device agreement: one program run on two devices, compared.

`chip_smoke.py` runs each check with the card against the CPU of the same
process; the tests run the same functions with two virtual CPU devices.
Tolerances, with their reasons:

* Keypoints: FAST scores and the pyramid are f32 sums taken in another
  order on each backend, so a score that ties at the candidate top-k or at
  a grid cell can fall either way: >= 99% of valid slots keep the same
  xy, octave and validity.
* Angle: atan2 of the same moments differs by ulps, so 1e-2 degrees,
  checked where the 32-bin BRIEF orientation agrees (a flip near a bin
  edge is a rounding tie, not an error).
* Descriptors: >= 99.9% identical bits over agreeing keypoints.  The
  blurred pyramid is rounded to integers and the sampling matmuls take
  0/1 weights, which TF32 holds exactly; what remains is orientation-bin
  flips.
* Poses: 1e-4 rad and 1e-4 map units.  A float32 matmul without a
  `precision` may run in TF32 on the card (10-bit mantissa), which moves
  a converged solve by far more than that, so the bound catches any
  geometry contraction left at default precision.
* Preintegration deltas: dR within 1e-4 rad; dV and dP within 1e-4
  relative to their size (over 512 dependent steps dP reaches tens of
  metres, and f32 round-off accumulates with it).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..features.extractor import FeatureFrame, OrbParams, extract_jit
from ..ops import brief, cameras, imu as imu_ops, lie
from ..parallel import dist_ba
from ..pipeline import mapping, system as base_sys
from ..slam_map import state as mapstate
from ..solver import inertial as inertial_solver
from ..solver import pose_opt, vi_pose_opt

KP_AGREE_MIN = 0.99
ANGLE_TOL_DEG = 1e-2
DESC_BIT_AGREE_MIN = 0.999
ROT_TOL_RAD = 1e-4
TRANS_TOL = 1e-4
REL_TOL = 1e-4


def on_device(fn, args: tuple, device):
    """Run `fn(*args)` with every input committed to `device`; returns
    host (numpy) copies of the outputs."""
    args = jax.device_put(args, device)
    with jax.default_device(device):
        out = fn(*args)
    return jax.device_get(out)


# ------------------------------------------------------------ feature frames
def feature_frame_agreement(a: FeatureFrame, b: FeatureFrame) -> dict:
    """Agreement statistics of two FeatureFrames of one image."""
    a, b = jax.device_get(a), jax.device_get(b)
    any_valid = np.asarray(a.valid) | np.asarray(b.valid)
    same_kp = ((a.valid == b.valid) & np.all(a.xy == b.xy, axis=1)
               & (a.octave == b.octave))
    both = same_kp & a.valid
    nb = brief.N_ANGLE_BINS
    bin_a = np.round(a.angle * (nb / 360.0)).astype(np.int64) % nb
    bin_b = np.round(b.angle * (nb / 360.0)).astype(np.int64) % nb
    same_bin = both & (bin_a == bin_b)
    d_ang = np.abs((a.angle - b.angle + 180.0) % 360.0 - 180.0)
    xor = np.bitwise_xor(a.desc[both], b.desc[both]).astype(np.uint32)
    diff_bits = int(np.unpackbits(xor.view(np.uint8)).sum())
    n_bits = 256 * int(both.sum())
    return dict(
        n_valid=int(any_valid.sum()),
        kp_agree=float(same_kp[any_valid].mean()) if any_valid.any()
        else 1.0,
        bin_flips=int((both & (bin_a != bin_b)).sum()),
        angle_max_err_deg=float(d_ang[same_bin].max()) if same_bin.any()
        else 0.0,
        desc_bit_agree=1.0 - diff_bits / n_bits if n_bits else 1.0)


def feature_frame_failures(stats: dict) -> list[str]:
    """Human-readable list of the bounds `stats` breaks (empty = pass)."""
    out = []
    if stats["kp_agree"] < KP_AGREE_MIN:
        out.append(f"keypoint agreement {stats['kp_agree']} < "
                   f"{KP_AGREE_MIN}")
    if stats["angle_max_err_deg"] > ANGLE_TOL_DEG:
        out.append(f"angle error {stats['angle_max_err_deg']} deg > "
                   f"{ANGLE_TOL_DEG}")
    if stats["desc_bit_agree"] < DESC_BIT_AGREE_MIN:
        out.append(f"descriptor bit agreement {stats['desc_bit_agree']} < "
                   f"{DESC_BIT_AGREE_MIN}")
    return out


# --------------------------------------------------------------------- poses
def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle (rad) of Ra^T Rb for stacks of rotations (..., 3, 3), from
    its skew part and trace (arccos of the trace alone loses ~1e-4 rad
    near zero on float32 matrices that are not exactly orthonormal)."""
    R = np.einsum("...ji,...jk->...ik", np.asarray(Ra, np.float64),
                  np.asarray(Rb, np.float64))
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return np.arctan2(0.5 * np.linalg.norm(w, axis=-1), 0.5 * (tr - 1.0))


def pose_agreement(Ra, ta, Rb, tb, mask=None) -> dict:
    """Largest rotation (rad) and translation differences of two pose
    stacks (..., 3, 3) / (..., 3), over `mask` when given."""
    rot = np.atleast_1d(rotation_angle(Ra, Rb))
    trans = np.atleast_1d(np.linalg.norm(
        np.asarray(ta, np.float64) - np.asarray(tb, np.float64), axis=-1))
    if mask is not None:
        rot, trans = rot[np.asarray(mask)], trans[np.asarray(mask)]
    return dict(rot_rad=float(rot.max(initial=0.0)),
                trans=float(trans.max(initial=0.0)))


def pose_failures(name: str, stats: dict) -> list[str]:
    out = []
    if not stats["rot_rad"] <= ROT_TOL_RAD:
        out.append(f"{name}: rotation {stats['rot_rad']} rad > "
                   f"{ROT_TOL_RAD}")
    if not stats["trans"] <= TRANS_TOL:
        out.append(f"{name}: translation {stats['trans']} > {TRANS_TOL}")
    return out


# -------------------------------------------------------------------- phases
def compare_extractor(img, p: OrbParams, dev, ref_dev) -> dict:
    """extract_jit on `dev` against `ref_dev` for one image."""
    fa = on_device(functools.partial(extract_jit, p=p), (img,), dev)
    fb = on_device(functools.partial(extract_jit, p=p), (img,), ref_dev)
    return feature_frame_agreement(fa, fb)


def _perturb_points(m, seed: int, sigma: float):
    noise = np.random.default_rng(seed).normal(
        0.0, sigma, m.pt_xyz.shape).astype(np.float32)
    return m._replace(pt_xyz=m.pt_xyz + jnp.asarray(noise))


def _kf_pose_stats(ma, mb, m0):
    mask = np.asarray(m0.kf_valid)
    return pose_agreement(ma.kf_R, ma.kf_t, mb.kf_R, mb.kf_t, mask)


def _frame_problem(sys_, ki: int):
    """Matched (X, uv, inv_sigma2, valid) of keyframe `ki` against its
    bound map points."""
    m = sys_.map
    ff = sys_.kf_features[ki]
    kp = sys_.kf_bindings[ki]
    P = m.pt_xyz.shape[0]
    pt = jnp.clip(kp, 0, P - 1)
    orb = sys_.cfg.orb
    sf = orb.scale_factor ** jnp.arange(orb.n_levels, dtype=jnp.float32)
    inv_s2 = 1.0 / sf[jnp.clip(ff.octave, 0, orb.n_levels - 1)] ** 2
    valid = (kp >= 0) & ff.valid & m.pt_valid[pt]
    return m.pt_xyz[pt], ff.xy, inv_s2, valid


def _perturb_pose(R, t, seed: int, rot: float = 0.01, trans: float = 0.02):
    d = np.random.default_rng(seed).normal(0.0, 1.0, 6).astype(np.float32)
    dR, dt = lie.se3_exp(jnp.asarray(
        np.concatenate([trans * d[:3], rot * d[3:]])))
    return lie.se3_compose(dR, dt, R, t)


def compare_visual_solvers(sys_, dev, ref_dev, seed: int = 0) -> dict:
    """The System's window BA (`ba_caps`) and the pose-only optimizer,
    each on `dev` against `ref_dev`, on the state a monocular run left."""
    out = {}
    ki = sys_.last_kf_idx
    m = _perturb_points(sys_.map, seed, 1e-3)
    center = jnp.asarray(ki, jnp.int32)
    ma = on_device(sys_._local_ba, (m, center, sys_.bank), dev)
    mb = on_device(sys_._local_ba, (m, center, sys_.bank), ref_dev)
    out["visual_local_ba"] = _kf_pose_stats(ma, mb, sys_.map)

    X, uv, inv_s2, valid = _frame_problem(sys_, ki)
    R0, t0 = _perturb_pose(sys_.map.kf_R[ki], sys_.map.kf_t[ki], seed)
    cam_model = sys_.cfg.cam_model

    @jax.jit
    def pose_only(R0, t0, X, uv, inv_s2, valid, cam):
        r = pose_opt.pose_optimization(R0, t0, X, uv, inv_s2, valid,
                                       cam_model, cam)
        return r.R, r.t

    args = (R0, t0, X, uv, inv_s2, valid, sys_.cam_params)
    Ra, ta = on_device(pose_only, args, dev)
    Rb, tb = on_device(pose_only, args, ref_dev)
    out["pose_only"] = pose_agreement(Ra, ta, Rb, tb)
    return out


def compare_inertial_solvers(sys_, dev, ref_dev, seed: int = 0) -> dict:
    """VI window BA (dense and PCG reduced solves) and the VI pose
    optimizer on the state an inertial run left, `dev` against
    `ref_dev`.

    On the card the window BA's translation differs from the CPU's by
    1e-5 to 8e-5 m from flight to flight, about the same at HIGHEST
    matmul precision and after 30 LM steps: f32 round-off in the solve,
    not TF32."""
    out = {}
    cfg, icfg = sys_.cfg, sys_.icfg
    ki = sys_.last_kf_idx
    m = _perturb_points(sys_.map, seed, 1e-3)
    center = jnp.asarray(ki, jnp.int32)
    f = sys_._window_factors()
    cams, pts, obs = cfg.ba_caps
    for schur, ba in (("dense", sys_._vi_local_ba),
                      ("pcg", sys_._make_vi_ba(
                          cfg.local_ba_window, cams, pts, obs,
                          icfg.vi_ba_iters, pcg=32, schur="pcg"))):
        ma = on_device(ba, (m, center, f, sys_.bank), dev)
        mb = on_device(ba, (m, center, f, sys_.bank), ref_dev)
        out[f"vi_local_ba_{schur}"] = _kf_pose_stats(ma, mb, sys_.map)

    # VI pose optimization of the newest keyframe against the previous
    # one through their preintegration factor
    i, j = sys_.preint_kf_pairs[-1]
    fK = inertial_solver.factor_from_preint(sys_.preints[-1])
    X, uv, inv_s2, valid = _frame_problem(sys_, j)
    mm = sys_.map
    Rwb_i, pwb_i = sys_._cam_to_body(mm.kf_R[i], mm.kf_t[i])
    Rc, tc = _perturb_pose(mm.kf_R[j], mm.kf_t[j], seed)
    Rwb_j, pwb_j = sys_._cam_to_body(Rc, tc)
    cam_model = cfg.cam_model

    @jax.jit
    def vi_pose(Rwb_j, pwb_j, vel_j, bias, Rwb_i, pwb_i, vel_i, fK,
                X, uv, inv_s2, valid, cam, Rcb, tcb):
        r = vi_pose_opt.vi_pose_optimization(
            Rwb_j, pwb_j, vel_j, bias, Rwb_i, pwb_i, vel_i, bias, fK,
            X, uv, inv_s2, valid, cam_model, cam, Rcb, tcb,
            imu_ops.GRAVITY)
        return r.Rwb, r.pwb

    args = (Rwb_j, pwb_j, mm.kf_vel[j], mm.kf_bias[j], Rwb_i, pwb_i,
            mm.kf_vel[i], fK, X, uv, inv_s2, valid, sys_.cam_params,
            sys_.Rcb, sys_.tcb)
    Ra, pa = on_device(vi_pose, args, dev)
    Rb, pb = on_device(vi_pose, args, ref_dev)
    out["vi_pose_opt"] = pose_agreement(Ra, pa, Rb, pb)
    return out


def compare_preintegration(sys_, dev, ref_dev, rows: int = 512,
                           seed: int = 0) -> dict:
    """The KF-interval preintegration program over `rows` IMU samples of
    a seeded random motion, `dev` against `ref_dev`."""
    rng = np.random.default_rng(seed)
    acc = (np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.5, (rows, 3))
           ).astype(np.float32)
    gyr = rng.normal(0, 0.3, (rows, 3)).astype(np.float32)
    dt = np.full(rows, 1.0 / sys_.icfg.imu_freq, np.float32)
    mask = np.ones(rows, bool)
    bias = np.zeros(6, np.float32)
    a = on_device(sys_._preint_kf, (acc, gyr, dt, mask, bias), dev)
    b = on_device(sys_._preint_kf, (acc, gyr, dt, mask, bias), ref_dev)

    def rel(x, y):
        return float(np.max(np.abs(x - y)) / max(1.0, np.max(np.abs(y))))

    return dict(rot_rad=float(rotation_angle(a.dR, b.dR)),
                dV_rel=rel(a.dV, b.dV), dP_rel=rel(a.dP, b.dP))


def preintegration_failures(stats: dict) -> list[str]:
    out = []
    if not stats["rot_rad"] <= ROT_TOL_RAD:
        out.append(f"preintegration dR {stats['rot_rad']} rad > "
                   f"{ROT_TOL_RAD}")
    for k in ("dV_rel", "dP_rel"):
        if not stats[k] <= REL_TOL:
            out.append(f"preintegration {k} {stats[k]} > {REL_TOL}")
    return out


# ------------------------------------------------------------- sharded BA
def synthetic_window_map(cap, cam_params, n_kf: int = 10,
                         pts_per_kf: int = 400, obs_per_pt: int = 3,
                         sigma: float = 0.005, seed: int = 0):
    """A map of `n_kf` keyframes strung along x, each creating
    `pts_per_kf` points that it and the next `obs_per_pt - 1` keyframes
    observe noise-free; the points are then perturbed so a window BA has
    work to do, and its optimum is the noise-free map.  Returns the map."""
    rng = np.random.default_rng(seed)
    cam = jnp.asarray(cam_params, jnp.float32)
    poses = [(np.eye(3, dtype=np.float32),
              np.array([-0.2 * k, 0.0, 0.0], np.float32))
             for k in range(n_kf)]
    X_all = []
    m = mapstate.empty_map(cap)
    for k in range(n_kf):
        m, _ = mapstate.add_keyframe(m, jnp.asarray(poses[k][0]),
                                     jnp.asarray(poses[k][1]), 0.1 * k, k)
    first = []
    for k in range(n_kf):
        X = np.stack([rng.uniform(-2.0, 2.0, pts_per_kf) + 0.2 * k,
                      rng.uniform(-1.5, 1.5, pts_per_kf),
                      rng.uniform(5.0, 7.0, pts_per_kf)], 1).astype(
                          np.float32)
        n = np.tile(np.array([0.0, 0.0, -1.0], np.float32),
                    (pts_per_kf, 1))
        m, idx = mapstate.add_points(
            m, jnp.asarray(X), jnp.zeros((pts_per_kf, 8), jnp.uint32),
            jnp.asarray(n), jnp.full(pts_per_kf, 0.1),
            jnp.full(pts_per_kf, 100.0), k, k, jnp.ones(pts_per_kf, bool))
        first.append(idx)
        X_all.append(X)
    for k in range(n_kf):
        for j in range(max(0, k - obs_per_pt + 1), k + 1):
            R, t = poses[k]
            uv = cameras.pinhole_project(
                cam, lie.se3_apply(jnp.asarray(R), jnp.asarray(t),
                                   jnp.asarray(X_all[j])))
            m = mapstate.add_observations(
                m, k, first[j], uv, jnp.zeros(pts_per_kf, jnp.int32),
                jnp.ones(pts_per_kf, bool))
    return _perturb_points(m, seed, sigma)


def compare_sharded_ba(devices, cfg, seed: int = 0,
                       iterations: int = 30) -> dict:
    """The engine's sharded window BA (`SlamConfig.ba_mesh_shards =
    len(devices)`, through `mapping.run_local_ba`) and each `dist_ba`
    communication mode, against the same solve on a one-device mesh.

    Both run `iterations` LM steps, enough to converge on the synthetic
    window: a truncated LM's accept decisions can flip on rounding
    differences between shard counts, so agreement is checked at the
    optimum."""
    n = len(devices)
    cfg = dataclasses.replace(cfg, ba_mesh_shards=n,
                              local_ba_iters=iterations,
                              enable_relocalization=False)
    mesh_n = Mesh(np.asarray(devices), ("shard",))
    mesh_1 = Mesh(np.asarray(devices[:1]), ("shard",))
    with jax.default_device(devices[0]):
        sys_ = base_sys.System(cfg)
        m = synthetic_window_map(cfg.map_capacity, cfg.cam_params,
                                 seed=seed)
        center = jnp.asarray(int(m.n_kf) - 1, jnp.int32)
    cams, pts, obs = cfg.ba_caps
    pts, obs = -(-pts // n) * n, -(-obs // n) * n

    @jax.jit
    def one_card(m, center):
        return mapping.run_local_ba(
            m, center, cfg.cam_model, sys_.cam_params,
            window=cfg.local_ba_window, iterations=cfg.local_ba_iters,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            stereo_bf=cfg.stereo_bf, mesh=mesh_1,
            pcg_iters=cfg.ba_pcg_iters,
            cap_cams=cams, cap_pts=pts, cap_obs=obs)

    out = {}
    ma = jax.device_get(sys_._local_ba(m, center))
    mb = jax.device_get(one_card(m, center))
    out["local_ba_mesh"] = _kf_pose_stats(ma, mb, m)

    prob = mapping.gather_window_problem(
        m, center, cfg.local_ba_window, cfg.orb.n_levels,
        cfg.orb.scale_factor, cap_cams=cams, cap_pts=pts, cap_obs=obs)[0]
    for comm in ("matvec", "dense", "camshard"):
        res = []
        for mesh, k in ((mesh_n, n), (mesh_1, 1)):
            R, t, X, _ = dist_ba.dist_bundle_adjust(
                dist_ba.partition_problem(prob, k), mesh,
                cam_model=cfg.cam_model, cam_params=sys_.cam_params,
                iterations=iterations, comm=comm)
            res.append((jax.device_get((R, t)), len(X.sharding.device_set)))
        ((Ra, ta), spread), ((Rb, tb), _) = res
        out[f"dist_ba_{comm}"] = dict(
            pose_agreement(Ra, ta, Rb, tb, np.asarray(prob.cam_valid)),
            point_shards_on=spread)
    return out

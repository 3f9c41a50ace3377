"""Verification drive (on the card): the engine at POD-SCALE capacity (1024 KF).

VERDICT r4 missing #2: every engine number so far was captured at the
256-KF default; the pod-scale code paths (matrix-free CG pose graph at
K >= 512, `covisibility_matrix` chunking past the 32 MB dense cutoff)
had only ever engaged in unit tests.  This drive runs the FULL System at
MapCapacity(1024 KF / 98k pts / 786k obs) on a long synthetic-feature
circuit that closes its loop at ~900 keyframes:

  * sustained tracking across ~6k frames with compaction/culling churn
    at capacity (0 resets),
  * loop detection runs the CHUNKED covisibility path every keyframe
    (98304 x 1024 incidence = 402 MB-equivalent, far past the dense
    cutoff),
  * the closure fires with K >= 512, so OptimizeEssentialGraph runs the
    matrix-free block-Jacobi CG solver (`pose_graph.py` auto-selects CG
    at K >= 512) — the single-threaded g2o solve this design replaces
    (/root/reference/src/Optimizer.cc:74-85) could not touch this size,
  * per-stage wall medians are reported.

DRIVE_FRAMES scales the circuit for CPU smoke runs (default 6600; the
smoke run exercises capacity allocation + chunked covis without the
closure).  Run on the card:  python tools/drives/drive_pod_scale.py
(background it; first compiles go through the remote service).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

K4 = (230.0, 230.0, 188.0, 120.0)
HW = (240, 376)
N_KP = 512


class CircuitWorld:
    """Landmark annulus under a look-down circuit flight.  Big enough
    that ~1000 distinct keyframes see mostly-fresh landmarks, with the
    revisit at lap end seeing the exact start imagery again."""

    def __init__(self, r_circ: float, seed=11, per_m=260):
        rng = np.random.default_rng(seed)
        n = int(2 * np.pi * r_circ * per_m)
        phi = rng.uniform(0, 2 * np.pi, n)
        rad = r_circ + rng.uniform(-2.5, 2.5, n)
        self.X = np.stack([
            rad * np.cos(phi), rad * np.sin(phi),
            rng.uniform(-0.6, 0.6, n)], 1).astype(np.float32)
        self.desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
        self.rng = rng
        print(f"world: {n} landmarks over a "
              f"{2 * np.pi * r_circ:.0f} m circuit", flush=True)

    def frame(self, R_cw, t_cw, noise_px=0.4, dropout=0.35):
        import jax.numpy as jnp
        from orbslam3_tpu.features.extractor import FeatureFrame
        Xc = self.X @ np.asarray(R_cw).T + np.asarray(t_cw)
        z = Xc[:, 2]
        uv = np.stack([K4[0] * Xc[:, 0] / np.maximum(z, 1e-6) + K4[2],
                       K4[1] * Xc[:, 1] / np.maximum(z, 1e-6) + K4[3]], 1)
        vis = (z > 0.3) & (uv[:, 0] > 8) & (uv[:, 0] < HW[1] - 8) & \
              (uv[:, 1] > 8) & (uv[:, 1] < HW[0] - 8)
        vis &= self.rng.random(len(z)) > dropout
        idx = np.nonzero(vis)[0]
        self.rng.shuffle(idx)
        idx = idx[:N_KP]
        n = len(idx)
        xy = uv[idx] + noise_px * self.rng.standard_normal((n, 2))
        desc = self.desc[idx].copy()
        w = self.rng.integers(0, 8, n)
        b = self.rng.integers(0, 32, n)
        desc[np.arange(n), w] ^= (np.uint32(1) << b.astype(np.uint32))
        pad = N_KP - n
        return FeatureFrame(
            xy=jnp.asarray(np.concatenate(
                [xy, np.zeros((pad, 2))]).astype(np.float32)),
            response=jnp.ones(N_KP),
            octave=jnp.zeros(N_KP, jnp.int32),
            angle=jnp.zeros(N_KP),
            desc=jnp.asarray(np.concatenate(
                [desc, np.zeros((pad, 8), np.uint32)])),
            valid=jnp.asarray(np.arange(N_KP) < n))


def main():
    import jax
    import jax.numpy as jnp
    print("devices:", jax.devices(), flush=True)

    from orbslam3_tpu.ops import align
    from orbslam3_tpu.pipeline import system as base_sys
    from orbslam3_tpu.slam_map import state as mapstate
    from orbslam3_tpu.utils import synth_render as sr

    n_frames = int(os.environ.get("DRIVE_FRAMES", 6600))
    lap = int(n_frames / 1.1)          # close the loop, retrace ~10%
    dt = 0.05
    # speed sized so one lap ~= lap frames; KF every ~6 frames ->
    # ~lap/6 keyframes at closure (~ = 1000 at the default length)
    r_circ = 0.05 * lap / (2 * np.pi)   # 0.05 m / frame along the arc
    world = CircuitWorld(r_circ)

    cap = mapstate.MapCapacity(n_kf=1024, n_pt=98304, n_obs=786432)
    cfg = base_sys.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=60,
        min_track_inliers=20, max_frames_between_kf=6,
        new_pt_budget=192, ba_caps=(16, 4096, 12288),
        map_capacity=cap, enable_loop_closing=True,
        post_loop_gba=os.environ.get("POD_GBA", "1") == "1",
        local_view_points=8192)
    sys_ = base_sys.System(cfg)

    def pose(i):
        phi = 2 * np.pi * (i % lap) / lap
        x = r_circ * np.cos(phi)
        y = r_circ * np.sin(phi)
        return sr.look_down_pose(x, y, 5.0, yaw=phi)

    t0 = time.time()
    gt = []
    track_t, kf_t = [], []
    n_ok = 0
    for i in range(n_frames):
        R_cw, t_cw = pose(i)
        ff = world.frame(R_cw, t_cw)
        nk0 = sys_.n_kf_host
        f0 = time.perf_counter()
        st, _ = sys_.track_monocular(None, ts=i * dt, features=ff)
        f1 = time.perf_counter()
        if i > 60:
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(f1 - f0)
        gt.append(-R_cw.T @ t_cw)
        if st == base_sys.OK:
            n_ok += 1
        if i % 500 == 0:
            print(f"frame {i}: state={st} n_kf={sys_.n_kf_host} "
                  f"n_pt={int(sys_.map.n_pt)} "
                  f"loops={sys_.loop_closer.n_loops_closed} "
                  f"resets={sys_.n_resets} t={time.time() - t0:.0f}s",
                  flush=True)
    g0 = time.perf_counter()
    sys_._merge_pending(force=True)    # absorb pending post-loop GBA
    gba_absorb_s = time.perf_counter() - g0
    wall = time.time() - t0

    est = np.stack([p_[2] for p_ in sys_.trajectory])
    ts_used = [p_[0] for p_ in sys_.trajectory]
    gt_m = np.stack([gt[int(round(t / dt))] for t in ts_used])
    rmse, s, _, _ = align.ate_rmse(jnp.asarray(est), jnp.asarray(gt_m))
    q = 3 * len(est) // 4
    rmse_q, _, _, _ = align.ate_rmse(jnp.asarray(est[q:]),
                                     jnp.asarray(gt_m[q:]))

    med = lambda xs: 1e3 * float(np.median(xs)) if xs else float("nan")
    n_kf = sys_.n_kf_host
    n_pt_live = int(jnp.sum(sys_.map.pt_valid.astype(jnp.int32)))
    n_obs = int(sys_.map.n_obs)
    loops = sys_.loop_closer.n_loops_closed
    print(f"\nframes OK: {n_ok}/{n_frames}  resets: {sys_.n_resets}")
    print(f"keyframes: {n_kf} (capacity {cap.n_kf})  live points: "
          f"{n_pt_live}  obs: {n_obs}")
    print(f"loops closed: {loops} (first at K>=512: "
          f"{'yes' if loops and n_kf >= 512 else 'n/a'})")
    print(f"tracked frame median {med(track_t):.1f} ms  KF frame median "
          f"{med(kf_t):.1f} ms  GBA absorb {gba_absorb_s:.1f} s")
    print(f"ATE (scale-aligned) {100 * float(rmse):.1f} cm  scale "
          f"{float(s):.4f}  last-quarter {100 * float(rmse_q):.1f} cm")
    print(f"wall: {wall:.0f} s")

    full = n_frames >= 6000
    ok = (sys_.n_resets == 0 and n_ok > 0.9 * n_frames and
          (not full or (n_kf >= 700 and loops >= 1 and
                        float(rmse) < 1.0)))
    print("DRIVE PASS" if ok else "DRIVE FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

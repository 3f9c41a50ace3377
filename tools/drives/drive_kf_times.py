"""Micro-drive (on the card): visual vs inertial keyframe-frame wall time.

VERDICT r3 weak #4 acceptance: with the bank-slab gather in the VI BA
(and the COO fallback deleted), an inertial keyframe frame should sit
within ~1 ms of the visual keyframe frame — the old gap was ~13 ms of
map-sized COO gather fixed cost.

Method: run the synthetic-feature visual pipeline and the mono-inertial
pipeline (same KF cadence, same caps), record the wall time of each
track_monocular call, split tracked frames from KF frames by the
keyframe counter, and report steady-state medians.  Both loops pay the
same host round trip per call, so the VISUAL-vs-INERTIAL DIFFERENCE isolates
the BA-program delta.

Run on the card:  python tools/drives/drive_kf_times.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "tests"))

import numpy as np


def median_ms(xs):
    return 1e3 * float(np.median(np.asarray(xs))) if xs else float("nan")


def run_visual(n_frames=120):
    from orbslam3_tpu.pipeline import system as slam_system
    from test_pipeline_e2e import HW, K4, SyntheticWorld, camera_path

    world = SyntheticWorld(seed=2)
    poses = camera_path(n_frames)
    cfg = slam_system.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=80,
        max_frames_between_kf=6, ba_caps=(24, 4096, 16384))
    sys_ = slam_system.System(cfg)
    track_t, kf_t = [], []
    for i, (R_cw, t_cw, _) in enumerate(poses):
        ff = world.frame(R_cw, t_cw)
        nk0 = sys_.n_kf_host
        t0 = time.perf_counter()
        sys_.track_monocular(None, ts=i * 0.05, features=ff)
        dt = time.perf_counter() - t0
        if i > n_frames // 3:                 # steady state only
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(dt)
    return track_t, kf_t, sys_.n_resets


def run_inertial(n_frames=120):
    from orbslam3_tpu.pipeline import inertial_system
    from test_inertial_pipeline import FPS, G, IMU_HZ, camera_path_smooth
    from test_pipeline_e2e import HW, K4, SyntheticWorld
    from orbslam3_tpu.pipeline import system as slam_system

    world = SyntheticWorld(seed=3)
    frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(n_frames)
    cfg = slam_system.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=80,
        max_frames_between_kf=6, ba_caps=(24, 4096, 16384))
    icfg = inertial_system.InertialConfig(
        imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5)
    sys_ = inertial_system.InertialSystem(cfg, icfg)
    dt_f, dt_i = 1.0 / FPS, 1.0 / IMU_HZ
    track_t, kf_t = [], []
    for i in range(n_frames):
        t_frame = i * dt_f
        if i > 0:
            t0s = (i - 1) * dt_f
            k = 1
            while t0s + k * dt_i <= t_frame + 1e-9:
                tm = t0s + k * dt_i
                Rb = rot(tm - 0.5 * dt_i)
                sys_.grab_imu(tm, rot_rate(tm - 0.5 * dt_i),
                              Rb.T @ (acc(tm - 0.5 * dt_i) - G))
                k += 1
        R_cw, t_cw, _, _ = frames[i]
        ff = world.frame(R_cw, t_cw)
        nk0 = sys_.n_kf_host
        t0 = time.perf_counter()
        sys_.track_monocular(None, ts=t_frame, features=ff)
        dt = time.perf_counter() - t0
        if sys_.imu_initialized:              # VI-BA path engaged
            (kf_t if sys_.n_kf_host > nk0 else track_t).append(dt)
    return track_t, kf_t, sys_.n_resets, sys_.imu_initialized


def main():
    import jax
    print("devices:", jax.devices(), flush=True)
    t0 = time.time()
    vt, vk, vr = run_visual()
    print(f"visual: tracked {median_ms(vt):.2f} ms (n={len(vt)})  "
          f"KF frame {median_ms(vk):.2f} ms (n={len(vk)})  resets={vr} "
          f"[{time.time() - t0:.0f}s]", flush=True)
    t0 = time.time()
    it, ik, ir, init = run_inertial()
    print(f"inertial: tracked {median_ms(it):.2f} ms (n={len(it)})  "
          f"KF frame {median_ms(ik):.2f} ms (n={len(ik)})  resets={ir} "
          f"imu_init={init} [{time.time() - t0:.0f}s]", flush=True)
    gap = median_ms(ik) - median_ms(vk)
    print(f"inertial-KF minus visual-KF: {gap:+.2f} ms", flush=True)
    ok = vr == 0 and ir == 0 and init
    print("DRIVE " + ("PASS" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

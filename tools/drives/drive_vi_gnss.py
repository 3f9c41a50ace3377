"""Verification drive (on the card): mono-inertial SLAM + GNSS geo-referencing.

Runs the full InertialSystem on a synthetic smooth trajectory with real
acceleration (scale observability), IMU at 200 Hz, and GNSS fixes in a
geo frame displaced by a known Sim3 (scale 3, yaw 0.7, offset).  Verifies
  * IMU init fires, recovered map scale is metric (alignment scale ~1),
  * post-init ATE is millimetric,
  * the GNSS geo-referenced trajectory lands on the true geo positions,
  * zero resets.

Run on the card:  timeout 570 python tools/drives/drive_vi_gnss.py
(the tests/ dir is imported for the pure-numpy synthetic world fixtures).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "tests"))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    print("devices:", jax.devices(), flush=True)
    from orbslam3_tpu.ops import align
    from orbslam3_tpu.pipeline import inertial_system, system as base_sys
    from test_inertial_pipeline import (FPS, G, IMU_HZ,
                                        camera_path_smooth)
    from test_pipeline_e2e import HW, K4, SyntheticWorld

    world = SyntheticWorld(seed=3)
    n_frames = 120
    frames, pos, vel, acc, rot, rot_rate = camera_path_smooth(n_frames)

    # geo frame: x_geo = s_geo * R_yaw x + t_geo
    s_geo = 3.0
    yaw = 0.7
    Rg = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0],
                   [0, 0, 1.0]])
    t_geo = np.array([500.0, -200.0, 30.0])

    cfg = base_sys.SlamConfig(
        cam_params=K4, image_hw=HW, min_init_matches=80,
        max_frames_between_kf=6, ba_caps=(24, 4096, 16384),
        enable_gnss=True, gnss_sigma=0.05, gnss_min_kfs=8,
        gnss_ba_every=4)
    icfg = inertial_system.InertialConfig(
        imu_freq=IMU_HZ, init_time_s=1.5, init_min_kfs=5)
    sys_ = inertial_system.InertialSystem(cfg, icfg)

    dt_f = 1.0 / FPS
    dt_i = 1.0 / IMU_HZ
    t_start = time.time()
    for i in range(n_frames):
        t_frame = i * dt_f
        if i > 0:
            t0 = (i - 1) * dt_f
            k = 1
            while t0 + k * dt_i <= t_frame + 1e-9:
                tm = t0 + k * dt_i
                Rb = rot(tm - 0.5 * dt_i)
                a_body = Rb.T @ (acc(tm - 0.5 * dt_i) - G)
                w_body = rot_rate(tm - 0.5 * dt_i)
                sys_.grab_imu(tm, w_body, a_body)
                k += 1
        # GNSS fix at frame cadence (true geo position of the camera)
        sys_.grab_gnss(t_frame, s_geo * (Rg @ pos(t_frame)) + t_geo)
        R_cw, t_cw, twc, Rwc = frames[i]
        ff = world.frame(R_cw, t_cw)
        st, pose = sys_.track_monocular(None, ts=t_frame, features=ff)
        if i % 30 == 0:
            print(f"frame {i}: state={st} imu_init={sys_.imu_initialized} "
                  f"({time.time() - t_start:.1f}s)", flush=True)
    wall = time.time() - t_start

    assert sys_.n_resets == 0, f"resets: {sys_.n_resets}"
    assert sys_.state == base_sys.OK, sys_.state
    assert sys_.imu_initialized, "IMU init never ran"

    est = np.stack([p[2] for p in sys_.trajectory])
    ts_used = [p[0] for p in sys_.trajectory]
    gt = np.stack([pos(t) for t in ts_used])
    n_half = len(est) // 2
    rmse_s, s, _, _ = align.ate_rmse(jnp.asarray(est[n_half:]),
                                     jnp.asarray(gt[n_half:]),
                                     with_scale=True)
    print(f"post-init ATE {float(rmse_s) * 1000:.2f} mm, "
          f"alignment scale {float(s):.4f}", flush=True)
    assert abs(float(s) - 1.0) < 0.1, float(s)
    assert float(rmse_s) < 0.05, float(rmse_s)

    # geo-referenced trajectory vs true geo positions (last 30 frames)
    assert sys_.georef is not None and sys_.georef.initialized, \
        "georef never initialized"
    geo = sys_.trajectory_geo()
    gt_geo = np.stack([s_geo * (Rg @ pos(t)) + t_geo for t in ts_used])
    err = np.linalg.norm(geo[-30:] - gt_geo[-30:], axis=1)
    print(f"geo-frame abs error (last 30): mean {err.mean() * 100:.2f} cm, "
          f"max {err.max() * 100:.2f} cm", flush=True)
    assert err.mean() < 0.15, err.mean()
    n_gba = getattr(sys_, "_n_gnss_ba", 0)
    print(f"gnss BAs dispatched: {n_gba}; wall {wall:.1f}s "
          f"({n_frames / wall:.1f} fps incl. host fixture)", flush=True)
    assert n_gba >= 1, "GNSS BA never dispatched"
    print("DRIVE OK", flush=True)


if __name__ == "__main__":
    main()
